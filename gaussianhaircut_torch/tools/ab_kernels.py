"""Time this checkout's compositing kernels against another checkout's, in
turns on one GPU.

    python3 -m gaussianhaircut_torch.tools.ab_kernels --baseline DIR [--reps 20]
        [--out FILE]

``DIR`` holds another commit's files (e.g. ``git archive <commit> | tar -x
-C DIR`` into a git-ignored directory).  Its ``ops/rasterize/cuda_core.py``
is loaded under another module name and builds that commit's kernels from
that commit's sources, into that directory; its ``raster_fwd`` and
``raster_bwd`` must take this checkout's arguments.  Both sides run on the
same inputs at two layouts:

- ``kernel``: the bench kernel shapes (``profile_fixed.bench_binned``:
  camera 0 of the bench scene, 100k slots, SH degree 3 active);
- ``train_final``: camera 0, SH degree 0, of the state ``train()`` reaches
  after 50 iterations of ``chip_smoke.py``'s train phase (densify from 10
  every 10, an opacity reset at 30).

Per round, each kernel (forward, backward) runs baseline, this
checkout, this checkout, baseline, each launch timed with CUDA events; the
medians over all rounds are reported with the per-round ratios.  The
outputs are compared too: the forwards bit for bit, the backwards by their
largest difference over each dpay row's max.  Prints one JSON line (and
writes it to ``--out``) with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics

import torch

from gaussianhaircut_torch.ops.rasterize import common as C
from gaussianhaircut_torch.ops.rasterize import cuda_core
from gaussianhaircut_torch.tools.profile_fixed import (
    _event_ms, bench_binned, binned_inputs, nvidia_smi)


def load_baseline(root: str):
    """The other checkout's cuda_core module, built."""
    path = os.path.join(root, "gaussianhaircut_torch", "ops", "rasterize", "cuda_core.py")
    spec = importlib.util.spec_from_file_location("baseline_cuda_core", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def train_final_binned(dev, cfg):
    """Camera 0, SH degree 0, of the bench scene after 50 train()
    iterations with chip_smoke.py's train-phase schedule."""
    from gaussianhaircut_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussianhaircut_torch.scene.synthetic import bench_scene
    from gaussianhaircut_torch.train import stage1
    scene = bench_scene(100_000, 960, 544, 4, 0)
    state = stage1.train(
        ModelConfig(sh_degree=3, use_barf=True, trainable_cameras=True,
                    trainable_intrinsics=True),
        OptimizationConfig(iterations=50, lambda_dorient=0.1, densify_from_iter=10,
                           densification_interval=10, opacity_reset_interval=30),
        PipelineConfig(tile=cfg.tile_w), scene, device=dev)
    binned, _ = binned_inputs(state.model.params, state.model.aux.alive, 0, scene,
                              0, cfg, dev)
    return binned


def compare(base, binned, width, height, cfg, reps: int) -> dict:
    dev = binned.payload.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    gbuf = torch.randn((binned.num_tiles, cfg.tile_pix, C.PAD_CHANNELS),
                       generator=gen, device=dev)
    gbuf[..., C.NUM_CHANNELS:C.CH_TRANS] = 0.0
    lay = (binned.payload, binned.chunk_start, binned.nchunks)
    tile_buf = cuda_core.raster_fwd(*lay, width, height, cfg)
    fns = {
        "fwd": {m: (lambda m=m: m.raster_fwd(*lay, width, height, cfg))
                for m in (base, cuda_core)},
        "bwd": {m: (lambda m=m: m.raster_bwd(*lay, tile_buf, gbuf, width, height, cfg))
                for m in (base, cuda_core)},
    }
    out = {"num_rendered": binned.num_rendered, "tiles": binned.num_tiles,
           "chunks_used": int(binned.nchunks.sum())}
    fb, fn = fns["fwd"][base](), fns["fwd"][cuda_core]()
    db, dn = fns["bwd"][base](), fns["bwd"][cuda_core]()
    torch.cuda.synchronize()
    scale = db.abs().amax(dim=(0, 2)).clamp(min=1e-30)
    out["fwd_bit_identical"] = bool(torch.equal(fb, fn))
    out["bwd_max_err_over_row_max"] = float(((dn - db).abs().amax(dim=(0, 2)) / scale).max())
    for name, pair in fns.items():
        for fn_ in pair.values():     # warm-up
            fn_()
            fn_()
        torch.cuda.synchronize()
        t = {base: [], cuda_core: []}
        ratios = []
        for _ in range(reps):
            a = _event_ms(pair[base])
            b1 = _event_ms(pair[cuda_core])
            b2 = _event_ms(pair[cuda_core])
            a2 = _event_ms(pair[base])
            t[base] += [a, a2]
            t[cuda_core] += [b1, b2]
            ratios.append((b1 + b2) / (a + a2))
        out[name] = {"baseline_ms": statistics.median(t[base]),
                     "new_ms": statistics.median(t[cuda_core]),
                     "ratio_median": statistics.median(ratios),
                     "ratio_min": min(ratios), "ratio_max": max(ratios)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="directory holding another checkout of the repository")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = C.RasterConfig(tile_w=32, tile_h=32, chunk=256)
    cuda_core.build()
    base = load_baseline(os.path.abspath(args.baseline))
    binned, width, height = bench_binned(dev, cfg)
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi(),
           "reps": args.reps, "order": "baseline, new, new, baseline per round",
           "kernel": compare(base, binned, width, height, cfg, args.reps)}
    del binned
    res["train_final"] = compare(base, train_final_binned(dev, cfg), width, height,
                                 cfg, args.reps)
    line = json.dumps(res)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
