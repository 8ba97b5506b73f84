"""Time the 3DGS compositor pair K4 (``composite_fwd``, T10) and K5
(``composite_bwd``, T11) on the slab of the fit's first step
(``chip_smoke.fit_scene_slabs``: 100k seeded random points from orbit
camera 0 at 512^2, 1024 tiles over 16 coarse cells of Kc = 2048), with the
plain compositor's times beside them (``chip_smoke.cuda_ms``: back-to-back
calls between CUDA events).

    python3 v3d_tpu_torch/kernels/time_gs_composite.py [--tree DIR] [--compare FILE]

``--tree`` imports ``v3d_tpu_torch`` from another checkout (its wrapper,
its sources, its build directory), so that one run on the card times two
trees' kernels in turns, e.g. a parent commit unpacked with ``git archive``
into ``build/parent``:

    for t in build/parent . . build/parent; do
        python3 v3d_tpu_torch/kernels/time_gs_composite.py --tree $t \
            --compare build/k4_outputs.pt; done

``--compare FILE``: the first tree writes its K4's six outputs (rgb, acc,
depth, ts, last, k_stop) to FILE; every later one prints each output's
max abs difference from those (ts over the rows both trees wrote: up to
the smaller k_stop, and the final row).  Where a tree's ``composite_fwd``
takes ``prof``, it also prints K4's clock64 cycles a tile (mean / max)
and the pairs its cull admitted, and times K4 on the busiest tile alone
(its blocks then have their SMs to themselves).

The slab and the cotangents come from seeded generators, the same in every
tree; the tree's forward is held against its plain compositor (rgb, acc max
abs <= 1e-4, depth <= 1e-3) and its slab gradient against the plain
autograd's (per attribute max abs <= 1e-3 max |plain|), chip_smoke.py's
bounds.  Prints its measurements and, last, one JSON object: the tree,
the card, K4's and K5's ms, K4's differences from the first tree.  Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_outputs(path: str, out, saved):
    """Write K4's six outputs to ``path`` where it does not exist (returns
    None), else print and return each one's max abs difference from those
    written there."""
    import torch

    (rgb, acc, dep), (ts, last, k_stop) = out, saved
    mine = {"rgb": rgb, "acc": acc, "depth": dep, "ts": ts, "last": last, "k_stop": k_stop}
    path = Path(path)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in mine.items()}, path)
        return None
    first = {k: v.to(rgb.device) for k, v in torch.load(path).items()}
    diffs = {}
    for name, x in mine.items():
        y = first[name]
        if name == "ts":  # rows past k_stop are unwritten
            rows = torch.arange(ts.shape[1], device=ts.device)[None]
            keep = rows < torch.minimum(k_stop, first["k_stop"])[:, None]
            tiles = torch.arange(len(k_stop), device=ts.device)
            x = torch.cat([x[keep].reshape(-1), x[tiles, k_stop.long()].reshape(-1)])
            y = torch.cat([y[keep].reshape(-1),
                           y[tiles, first["k_stop"].long()].reshape(-1)])
        diffs[name] = float((x.double() - y.double()).abs().max())
    print("K4 outputs, max abs difference from the first tree's: "
          + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items()), flush=True)
    return diffs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=str(ROOT),
                   help="checkout whose v3d_tpu_torch is timed (default: this one)")
    p.add_argument("--compare", default=None,
                   help="file of K4's outputs: written by the first tree, compared by the rest")
    args = p.parse_args(argv)
    tree = Path(args.tree).resolve()
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(tree)] + [q for q in sys.path if Path(q or ".").resolve() != here]
    cs = _chip_smoke()

    import torch

    import v3d_tpu_torch
    from v3d_tpu_torch.ops import gs_composite as gc

    if Path(v3d_tpu_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"v3d_tpu_torch came from {v3d_tpu_torch.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("time_gs_composite: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    slabs = cs.fit_scene_slabs(dev)
    args_ = (slabs.slab.detach().contiguous(), slabs.live_count, slabs.cell_of_tile,
             slabs.tile_xy)
    out, saved = gc.composite_fwd(*args_)
    ref = gc.composite_plain(*args_)
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    if not (max(errs[:2]) <= cs.GS_RGB_ACC_MAX_ABS and errs[2] <= cs.GS_DEPTH_MAX_ABS):
        raise SystemExit(f"K4 disagrees with the plain compositor: {errs}")
    gen = torch.Generator(device=dev).manual_seed(1)
    cot = [torch.randn(o.shape, device=dev, generator=gen) for o in out]
    dslab = gc.composite_bwd(args_[0], args_[2], args_[3], saved, *cot)
    slab = args_[0].clone().requires_grad_(True)
    (want,) = torch.autograd.grad(gc.composite_plain(slab, *args_[1:]), slab, cot)
    rel = [float((dslab[..., a] - want[..., a]).abs().max())
           / max(float(want[..., a].abs().max()), 1e-30) for a in range(gc.ATTR)]
    if max(rel) > cs.GS_GRAD_REL:
        raise SystemExit(f"K5 disagrees with the plain backward: {rel}")
    del want, slab, ref
    diffs = compare_outputs(args.compare, out, saved) if args.compare else None
    if "prof" in inspect.signature(gc.composite_fwd).parameters:
        prof = torch.zeros(args_[2].shape[0], gc.FWD_PROF_SLOTS, dtype=torch.int64,
                           device=dev)
        gc.composite_fwd(*args_, prof=prof)
        torch.cuda.synchronize()
        cyc = prof[:, :4].double()
        print("K4 clock64 cycles a tile (the most of its blocks), mean / max: " + ", ".join(
            f"{name} {float(cyc[:, i].mean()):,.0f} / {float(cyc[:, i].max()):,.0f}"
            for i, name in enumerate(("all", "cull", "walk", "final writes")))
            + f" | admitted pairs {int(prof[:, 4].sum()):,}, staged "
            f"{int(prof[:, 5].sum()):,}; the busiest tile staged "
            f"{int(prof[int(prof[:, 0].argmax()), 5]):,} (most {int(prof[:, 5].max()):,})",
            flush=True)
        # the busiest tile alone on the card: its walk without other blocks
        # beside it on its SMs
        one = prof[:, 0].argmax().reshape(1)
        alone = (args_[0], args_[1], args_[2][one].contiguous(), args_[3][one].contiguous())
        prof1 = torch.zeros(1, gc.FWD_PROF_SLOTS, dtype=torch.int64, device=dev)
        gc.composite_fwd(*alone, prof=prof1)
        alone_ms = cs.cuda_ms(lambda: gc.composite_fwd(*alone))
        print(f"K4 on the busiest tile alone: {alone_ms:.4f} ms; cycles of its "
              f"slowest block: all {int(prof1[0, 0]):,}, walk {int(prof1[0, 2]):,}", flush=True)
    fwd_ms = cs.cuda_ms(lambda: gc.composite_fwd(*args_))
    bwd_ms = cs.cuda_ms(lambda: gc.composite_bwd(args_[0], args_[2], args_[3], saved, *cot))
    print(f"slab {tuple(args_[0].shape)} {args_[2].shape[0]} tiles: K4 {fwd_ms:.4f} ms, "
          f"K5 {bwd_ms:.4f} ms; K5 per attribute max_abs / max|plain| <= "
          f"{max(rel):.2e}", flush=True)
    print(json.dumps({"tree": str(tree), "card": card, "k4_ms": fwd_ms, "k5_ms": bwd_ms,
                      "k5_max_rel": max(rel), "k4_max_abs_vs_first_tree": diffs}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
