"""GPU smoke run of the PyTorch port: builds the kernels, holds each against
its plain PyTorch version, drives the main path, and prints the results.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
1. card: name and power limit from nvidia-smi; a CUDA device is required;
2. build: compile the CUDA kernels from judo_tpu_torch/csrc;
3. kernel vs plain: the fused rollout kernel against rollout_lanes_reference
   on the leap model, 320 rollouts, 5 steps, warm-start forces carried, in
   float64 and float32;
4. main path: make_controller("leap_cube", "mppi") on cuda, float32, 320
   rollouts, 3 warm-up and 20 timed update_action calls; the kernel's launch
   count must grow by one per solve; plus one float64 solve on 16 rollouts
   with shared noise held against the same solve on the CPU;
5. timing: one 320-rollout, 100-step rollout through the kernel and through
   the plain version.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

LIMITS = {"f64": 1e-8, "f32": 1e-3, "f32_efc0_rel": 1e-2, "solve_f64": 1e-6}
B_MAIN, T_CHECK, T_FULL = 320, 5, 100


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def leap_inputs(m, B: int, T: int, seed: int, dtype, device):
    """Perturbed contact states and controls around the resting cube."""
    import torch

    from judo_tpu_torch.tasks.leap_cube import QPOS_REST

    rng = np.random.default_rng(seed)
    qp = np.tile(QPOS_REST, (B, 1))
    qp[:, :3] += 5e-4 * rng.standard_normal((B, 3))
    qv = 0.05 * rng.standard_normal((B, m.nv))
    ct = np.tile(QPOS_REST[7:], (T, B, 1)).transpose(0, 2, 1) + 0.1 * rng.standard_normal((T, m.nu, B))

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return t(qp.T), t(qv.T), t(ct)


def kernel_vs_plain(dtype_name: str) -> dict:
    import torch

    from judo_tpu_torch.physics.fused_rollout import fused_rollout, num_constraint_rows, rollout_lanes_reference
    from judo_tpu_torch.tasks.leap_cube import LeapCube

    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    m = LeapCube(device="cuda", dtype=dtype).planning_model
    qp, qv, ct = leap_inputs(m, B_MAIN, T_CHECK + 1, seed=1, dtype=dtype, device="cuda")
    nefc = num_constraint_rows(m)
    zeros = torch.zeros((nefc, B_MAIN), dtype=dtype, device="cuda")
    # onset forces from one plain step: the carried warm start of a real solve
    f0 = rollout_lanes_reference(m, qp, qv, ct[:1], zeros, 1, 8)[3]
    ref = rollout_lanes_reference(m, qp, qv, ct[1:], f0, 1, 8)
    out = fused_rollout(m, qp, qv, ct[1:].contiguous(), f0, 1, 8)
    torch.cuda.synchronize()
    err = {n: float((a - b).abs().max()) for n, a, b in zip(("states", "qvel", "sensors", "efc0"), ref, out)}
    err["states"] = max(err["states"], err.pop("qvel"))
    scale = float(ref[3].abs().max())
    err["efc0_rel"] = err["efc0"] / max(scale, 1e-30)
    err["efc0_scale"] = scale
    return err


def main_path() -> dict:
    import torch

    from judo_tpu_torch.controller import make_controller
    from judo_tpu_torch.physics.fused_rollout import fused_rollout
    from judo_tpu_torch.tasks.leap_cube import QPOS_REST

    c = make_controller("leap_cube", "mppi", device="cuda", dtype=torch.float32, seed=0)
    c.optimizer_cfg.num_rollouts = B_MAIN
    rng = np.random.default_rng(2)
    base = np.concatenate([QPOS_REST, np.zeros(c.pm.nv)])

    def perturbed():
        s = base.copy()
        s[:3] += 5e-4 * rng.standard_normal(3)
        s[c.pm.nq :] += 0.02 * rng.standard_normal(c.pm.nv)
        return s

    for _ in range(3):
        c.current_state = perturbed()
        c.update_action()
    fused_rollout.launches = 0
    times = []
    for _ in range(20):
        c.current_state = perturbed()
        t0 = time.perf_counter()
        c.update_action()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    launches = fused_rollout.launches
    if launches != 20:
        raise RuntimeError(f"kernel launches {launches} != 20 solves")
    lo, hi = c.task.actuator_ctrlrange[:, 0], c.task.actuator_ctrlrange[:, 1]
    knots = np.asarray(c.nominal_knots)
    if not np.all(np.isfinite(c.rewards)) or c.rewards.shape != (B_MAIN,):
        raise RuntimeError(f"rewards not finite or wrong shape: {c.rewards.shape}")
    if not np.all(np.isfinite(knots)) or np.any(knots < lo - 1e-6) or np.any(knots > hi + 1e-6):
        raise RuntimeError("nominal knots not finite or outside the control range")
    return {
        "launches": launches, "p50_ms": float(np.percentile(times, 50)), "p95_ms": float(np.percentile(times, 95)),
        "reward_max": float(c.rewards.max()), "reward_min": float(c.rewards.min()),
    }


def solve_gpu_vs_cpu() -> float:
    """One float64 solve on 16 rollouts with shared noise: cuda vs cpu."""
    import torch

    from judo_tpu_torch.controller import make_controller
    from judo_tpu_torch.tasks.leap_cube import QPOS_REST

    R = 16
    noise = np.random.default_rng(3).standard_normal((R - 1, 4, 16))
    out = {}
    for dev in ("cpu", "cuda"):
        c = make_controller("leap_cube", "mppi", device=dev, dtype=torch.float64, seed=0)
        c.optimizer_cfg.num_rollouts = R
        c.controller_cfg.horizon = 0.2
        opt = c.optimizer
        opt.sample = lambda p, s, nom, g, opt=opt: opt.sample_from_noise(
            p, s, nom, torch.as_tensor(noise, dtype=nom.dtype, device=nom.device)
        )
        c.current_state = np.concatenate([QPOS_REST, np.zeros(c.pm.nv)])
        c.update_action()
        out[dev] = (c.rewards.copy(), np.asarray(c.nominal_knots).copy())
    return float(max(np.abs(out["cpu"][0] - out["cuda"][0]).max(), np.abs(out["cpu"][1] - out["cuda"][1]).max()))


def timing() -> tuple[float, float]:
    import torch

    from judo_tpu_torch.physics.fused_rollout import fused_rollout, num_constraint_rows, rollout_lanes_reference
    from judo_tpu_torch.tasks.leap_cube import LeapCube

    m = LeapCube(device="cuda", dtype=torch.float32).planning_model
    qp, qv, ct = leap_inputs(m, B_MAIN, T_FULL, seed=4, dtype=torch.float32, device="cuda")
    f0 = torch.zeros((num_constraint_rows(m), B_MAIN), dtype=torch.float32, device="cuda")
    fused_rollout(m, qp, qv, ct, f0, 1, 8)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        fused_rollout(m, qp, qv, ct, f0, 1, 8)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end) / reps
    start.record()
    rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8)
    end.record()
    torch.cuda.synchronize()
    return kernel_ms, start.elapsed_time(end)


def main() -> int:
    import torch

    print(f"card: {card_info()}", flush=True)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this run needs a CUDA GPU", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    from judo_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load("cuda")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log("cuda").splitlines():
        if "registers" in line or "spill" in line or "build seconds" in line:
            print(f"  {line.strip()}")

    ok = True
    errs = {}
    for name in ("f64", "f32"):
        e = kernel_vs_plain(name)
        errs[name] = e
        if name == "f64":
            checks = [(k, e[k], LIMITS["f64"]) for k in ("states", "sensors", "efc0")]
        else:
            checks = [("states", e["states"], LIMITS["f32"]), ("sensors", e["sensors"], LIMITS["f32"]),
                      ("efc0_rel", e["efc0_rel"], LIMITS["f32_efc0_rel"])]
        for k, v, lim in checks:
            good = v <= lim
            ok &= good
            print(f"kernel vs plain {name} B={B_MAIN} T={T_CHECK} {k}: max err {v:.3e} limit {lim:.0e} "
                  f"{'ok' if good else 'FAIL'} (|efc0| max {e['efc0_scale']:.3e})", flush=True)
    if not ok:
        return 1

    card = card_info()
    mp = main_path()
    print(f"main path leap_cube mppi R={B_MAIN} f32: p50 {mp['p50_ms']:.2f} ms p95 {mp['p95_ms']:.2f} ms "
          f"launches {mp['launches']}/20 rewards [{mp['reward_min']:.4f}, {mp['reward_max']:.4f}] on {card}",
          flush=True)
    d = solve_gpu_vs_cpu()
    print(f"solve f64 R=16 T=20 cuda vs cpu (shared noise): max err {d:.3e} limit {LIMITS['solve_f64']:.0e}", flush=True)
    if not d <= LIMITS["solve_f64"]:
        return 1

    kernel_ms, plain_ms = timing()
    print(f"rollout B={B_MAIN} T={T_FULL} f32: kernel {kernel_ms:.3f} ms, plain PyTorch {plain_ms:.1f} ms on {card}",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "fused_rollout", "route": "cuda", "source": "judo_tpu_torch/csrc/fused_rollout.cu",
        "replaces": "judo_tpu/physics/pallas_step.py:162", "launches": mp["launches"],
        "max_abs_err": errs["f32"]["states"], "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
