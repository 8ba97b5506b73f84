"""idle_pct.gen (%): 1 - the device's busy time in the traced request over
the mean wall time of the window's requests, which ran without the
profiler (the profiler slows the host, not the device).  Moves gen_s."""


def read(rec):
    if rec.profile is None or not rec.units:
        return None
    busy = rec.profile.busy_s / rec.profile.units
    return 100.0 * (1.0 - busy / (rec.window_s / rec.units))
