"""Roofline / utilization analysis for the flagship lane-major solve, on one
NVIDIA GPU.

Method:
  * build the EXACT headline program (bench.build, lane backend, batch 512,
    robust 14x3+6+4 budget) and AOT-compile it;
  * read XLA's own cost model from ``compiled.cost_analysis()`` — flops and
    bytes accessed of the optimized HLO (post-fusion, the program actually
    dispatched);
  * measure wall time per iteration on the host clock (pipelined reps, same
    protocol as bench.bench_solves);
  * compare achieved FLOP/s and bytes/s against the card's published peaks
    (``PEAKS``, keyed by ``device_kind``) and derive the speed-of-light time
    per solve batch;
  * report the binding constraint: compute-bound / bandwidth-bound /
    DEPENDENCY-bound (the measured time exceeds both rooflines' floors —
    the program is a serial chain of small fused steps whose latency, not
    throughput, sets the rate).

Prints one JSON object (with the card's name and power limit) and a short
text summary. A device missing from ``PEAKS`` is an error.

Usage:  python tools/roofline.py [--batch 512]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

from safe_exploration_tpu.utils.device import (
    gpu_name_and_power_limit,
    require_gpu,
)

# Published dense peaks by device_kind: NVIDIA H100 data sheet, SXM part, at
# its full 700 W power limit. The compute peak is float32 OUTSIDE the tensor
# cores, because the package pins matmul precision to "highest" (no TF32;
# safe_exploration_tpu/__init__.py).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_kind: str) -> dict:
    if device_kind not in PEAKS:
        raise SystemExit(f"no published peaks for device_kind "
                         f"{device_kind!r}; add them to tools/roofline.PEAKS")
    return PEAKS[device_kind]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--n-max", type=int, default=128)
    ap.add_argument("--n-data", type=int, default=64)
    ap.add_argument("--n-safe", type=int, default=5)
    args = ap.parse_args()

    device = require_gpu()
    device["nvidia_smi"] = gpu_name_and_power_limit()
    peak = peaks_for(device["kind"])

    from bench import build

    solve, ssm, x0s, warm = build(args.batch, args.n_max, args.n_data,
                                  args.n_safe, jnp.float32)

    lowered = solve.lower(x0s, warm)
    compiled = lowered.compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, list):  # older jax returns [dict]
        cost = cost[0]
    flops = float(cost.get("flops", float("nan")))
    bytes_acc = float(cost.get("bytes accessed", float("nan")))

    out = compiled(x0s, warm)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = compiled(x0s, warm)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / args.iters  # s per batch solve

    solves_per_sec = args.batch / dt
    achieved_flops = flops / dt
    achieved_bw = bytes_acc / dt
    f32_peak = peak["f32_flops"]
    sol_compute_s = flops / f32_peak
    sol_bw_s = bytes_acc / peak["hbm_bytes_per_s"]
    sol_s = max(sol_compute_s, sol_bw_s)

    util_flops = achieved_flops / f32_peak
    util_bw = achieved_bw / peak["hbm_bytes_per_s"]
    if util_flops > 0.5:
        binding = "compute-bound"
    elif util_bw > 0.5:
        binding = "bandwidth-bound"
    else:
        binding = "dependency-bound (serial small-step latency)"

    rec = {
        "batch": args.batch,
        "solves_per_sec": round(solves_per_sec, 1),
        "time_per_batch_ms": round(dt * 1e3, 3),
        "hlo_flops_per_batch": flops,
        "hlo_bytes_per_batch": bytes_acc,
        "achieved_tflops": round(achieved_flops / 1e12, 3),
        "achieved_gbps": round(achieved_bw / 1e9, 2),
        "f32_util_pct": round(100 * util_flops, 2),
        "hbm_util_pct": round(100 * util_bw, 2),
        "speed_of_light_ms": round(sol_s * 1e3, 4),
        "headroom_x_vs_sol": round(dt / sol_s, 1) if sol_s > 0 else None,
        "binding_constraint": binding,
        "device": device,
    }
    print(json.dumps(rec))
    print(
        f"\n{solves_per_sec:,.0f} solves/s  |  {dt*1e3:.2f} ms / batch-{args.batch}\n"
        f"HLO cost: {flops/1e9:.2f} GFLOP, {bytes_acc/1e6:.1f} MB accessed per batch\n"
        f"achieved: {achieved_flops/1e12:.3f} TFLOP/s "
        f"({100*util_flops:.2f}% of the {f32_peak/1e12:.0f} TFLOP/s f32 peak), "
        f"{achieved_bw/1e9:.1f} GB/s ({100*util_bw:.2f}% of HBM)\n"
        f"speed of light: {sol_s*1e3:.3f} ms "
        f"(compute {sol_compute_s*1e3:.3f} / bw {sol_bw_s*1e3:.3f}) "
        f"-> measured is {dt/sol_s:.0f}x above SOL\n"
        f"binding constraint: {binding}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
