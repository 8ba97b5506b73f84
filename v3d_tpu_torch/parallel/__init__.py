"""Multi-device path (counterpart of v3d_tpu/parallel): the ("data",
"model") device mesh, batch sharding, replication and tensor-parallel
placement (``mesh``), and the multi-rank dry run (``dryrun``)."""
