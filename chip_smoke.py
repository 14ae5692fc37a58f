"""GPU smoke run of the PyTorch port: builds the kernels, holds each against
its plain PyTorch version, drives every path through its entry points, and
prints the results.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases (every phase runs; any check that fails, or any error, exits non-zero
without the final line):
1. card: name and power limit from nvidia-smi; a CUDA device is required;
2. build: compile the CUDA kernels from judo_tpu_torch/csrc (one nvcc per
   source, in parallel); print each kernel's registers and spills, and for
   each scene and dtype its scratch layout (all in shared memory, or J in a
   slab of global memory where the whole scratch exceeds the card's
   per-block limit), its dynamic shared memory per block and the blocks that
   stay resident on one SM;
3. kernel vs plain version, float64 and float32:
   - fused_rollout (K1) against rollout_lanes_reference, 5 steps, warm-start
     forces carried: the leap model at 320 and 33 rollouts, cylinder_push
     (cylinder-cylinder and cylinder-box pairs) at 32 and 33, fr3_pick
     (capsule-capsule pairs, the finger-coupling equality rows, five distance
     sensors) at 64 and 33;
   - fused_policy_rollout (K2) against policy_rollout_lanes_reference on
     spot_navigate, 24 and 80 rollouts, 3 policy ticks, a random nonzero
     starting policy output; and on spot_box_push, spot_tire_roll and
     spot_tire_upright (the object against the front feet, 5 mm into the
     ground; the tire of spot_tire_upright tipped onto its rim), 24
     rollouts, 3 ticks, with the plain version's own float32 vs float64
     error beside each float32 check; and with that tire lying flat, where
     the plane-cylinder rim direction is rounding noise, over 1 tick;
   - physics_step (K3) against step_l with a cold probe, leap at 320, spot
     at 24 and fr3_pick at 64 rollouts;
4. paths, each driven with every launch count set to 0 just before it and
   read just after:
   - leap: make_controller("leap_cube", "mppi") on cuda, float32, 320
     rollouts, 3 warm-up and 10 timed solves, one K1 launch per solve;
   - spot: make_controller("spot_navigate", "mppi") on cuda, float32, 24
     rollouts, 2 s horizon (100 policy ticks x 2 physics steps), 1 warm-up
     and 5 timed solves, one K2 launch per solve;
   - single step: physics_step on the leap model at 320 rollouts;
   - cylinder_push: make_controller("cylinder_push", "ps") (the CLI's
     default), 32 rollouts, 1 s horizon (T = 52 steps of 20 ms), 3 warm-up and
     10 timed solves, one K1 launch per solve;
   - fr3_pick: make_controller("fr3_pick", "cem"), 64 rollouts, 1 s horizon
     (T = 252 steps of 4 ms), 1 warm-up and 5 timed solves, one K1 launch per
     solve;
   - spot_box_push, spot_tire_roll, spot_tire_upright: make_controller(task,
     "mppi") at its defaults (24 rollouts, 3 knots, 2 s horizon, T = 100
     policy ticks x 2 physics steps), 1 warm-up and 5 timed solves, one K2
     launch per solve;
   - pipelining: leap_cube + mppi (320 rollouts) and spot_navigate + mppi at
     pipeline_depth 0 and 2, 5 + 20 calls each on the same states, as
     bench.py times them (host
     time of each update_action; at depth 2 in steady state); every depth-2
     call must return before the card has run the solve it dispatched, and
     the flushed depth-2 run must have published depth 0's mirrors, bitwise;
     one depth-2 call under torch.cuda.set_sync_debug_mode("warn"), whose
     warnings (each an operation that waits for the card) must be none;
5. one float64 solve per path, cuda against cpu with shared noise (leap and
   spot with MPPI, cylinder_push with PS, fr3_pick with CEM, spot_box_push
   with MPPI, whose float64 kernel runs with J in global memory);
6. timing with CUDA events: each kernel against its plain version, and its
   bound (the larger of its bytes over the memory rate and its operations
   over the float32 rate, counted from the shapes of this run); K1 also on
   cylinder_push (32 rollouts, T 52) and fr3_pick (64, T 252); K2 also with
   no physics substeps, which leaves the policy's share of a tick, and on the
   three object scenes at R 24, T 100 x 2 (their plain version timed over 3
   ticks).
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

LIMITS = {"f64": 1e-8, "f32": 1e-3, "f32_efc0_rel": 1e-2, "f32_distance": 1e-2, "solve_f64": 1e-6,
          "f32_flat_tire_vs_own": 2.0}
# f32_distance: distance sensors in float32. Their box-box separation along a
# near-parallel edge axis divides by 1 - R^2 (about 3e-4 for fr3's finger and
# object boxes near the home pose), so float32 rounding of the orientations
# reaches 1e-3: the plain version in float32 departs from itself in float64 by
# as much on the same inputs (printed beside each check).
# f32_flat_tire_vs_own: K2 in float32 on the flat tire may depart from the
# plain version by twice the plain version's own float32 vs float64 error on
# the same inputs. There the plane-cylinder rim direction is float32 rounding
# noise against the 1e-8 fallback, so the tire rests on a rim point that any
# change in the order of operations moves (PERF.md section 6).
B_MAIN, T_CHECK, T_FULL = 320, 5, 100
R_SPOT, T_POLICY_CHECK = 24, 3
# The Spot tasks with an object; K2 plans them all.
OBJECT_TASKS = ("spot_box_push", "spot_tire_roll", "spot_tire_upright")
# The tire of spot_tire_upright in K2's checks: tipped 0.5 rad onto its rim.
# Lying flat, its axis is along the ground's normal, where plane-cylinder's
# rim direction is rounding noise and the tire rests on one rim point, so
# the dynamics from there split apart at the rounding of the operations
# (section 6 of PERF.md): the flat tire has a check of its own, over 1 tick.
TIRE_TILT, T_FLAT = 0.5, 1
# Rollouts of the K1 checks per scene, and of the K3 check.
K1_B = {"leap": (B_MAIN, 33), "cylinder_push": (32, 33), "fr3": (64, 33)}
K3_B = {"leap": B_MAIN, "spot": R_SPOT, "fr3": 64}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside
# the tensor cores.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def tensor(x, dtype, device):
    import torch

    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def leap_inputs(m, B: int, T: int, seed: int, dtype, device):
    """Perturbed contact states and controls around the resting cube."""
    from judo_tpu_torch.tasks.leap_cube import QPOS_REST

    rng = np.random.default_rng(seed)
    qp = np.tile(QPOS_REST, (B, 1))
    qp[:, :3] += 5e-4 * rng.standard_normal((B, 3))
    qv = 0.05 * rng.standard_normal((B, m.nv))
    ct = np.tile(QPOS_REST[7:], (T, B, 1)).transpose(0, 2, 1) + 0.1 * rng.standard_normal((T, m.nu, B))
    return tensor(qp.T, dtype, device), tensor(qv.T, dtype, device), tensor(ct, dtype, device)


# A pusher touching the cart (cylinder_push), and the arm around its home pose
# with the object on the table (fr3_pick).
CYLINDER_PUSH_CONTACT = np.array([0.0, 0.0, 0.45, 0.05])


def scene_inputs(scene: str, m, B: int, T: int, seed: int, dtype, device):
    """(qpos (nq, B), qvel (nv, B), ctrl (T, nu, B)) of a scene: states with
    active contacts, and controls around the task's warm start."""
    if scene == "leap":
        return leap_inputs(m, B, T, seed, dtype, device)
    rng = np.random.default_rng(seed)
    if scene == "cylinder_push":
        qp = np.tile(CYLINDER_PUSH_CONTACT, (B, 1)) + 0.02 * rng.standard_normal((B, 4))
        qv = 0.3 * rng.standard_normal((B, m.nv))
        ct = 0.5 * rng.standard_normal((T, m.nu, B))
    else:
        from judo_tpu_torch.tasks.fr3_pick import QPOS_HOME

        qp = np.tile(QPOS_HOME, (B, 1))
        qp[:, 7:14] += 0.05 * rng.standard_normal((B, 7))
        qv = 0.1 * rng.standard_normal((B, m.nv))
        warm = np.r_[QPOS_HOME[7:14], 0.04]
        ct = np.tile(warm, (T, B, 1)).transpose(0, 2, 1) + 0.05 * rng.standard_normal((T, m.nu, B))
    return tensor(qp.T, dtype, device), tensor(qv.T, dtype, device), tensor(ct, dtype, device)


def scene_model(scene: str, dtype):
    from judo_tpu_torch.tasks import get_registered_tasks

    name = {"leap": "leap_cube", "fr3": "fr3_pick"}.get(scene, scene)
    return get_registered_tasks()[name][0](device="cuda", dtype=dtype).planning_model


def spot_inputs(task, B: int, T: int, seed: int, dtype, device):
    """Standing states with small velocities, a random nonzero policy output,
    and walking commands (base velocity, stowed arm, standing height)."""
    from judo_tpu_torch.tasks.spot import spot_constants as sc

    rng = np.random.default_rng(seed)
    qp = np.tile(task.qpos, (B, 1)).T
    qv = 0.05 * rng.standard_normal((task.nv, B))
    po = 0.3 * rng.standard_normal((12, B))
    cmd = np.zeros((T, 25, B))
    cmd[:, :3] = 0.5 * rng.standard_normal((T, 3, B))
    cmd[:, 3:10] = sc.ARM_STOWED_POS[None, :, None]
    cmd[:, 24] = sc.STANDING_HEIGHT_CMD
    return [tensor(x, dtype, device) for x in (qp, qv, po, cmd)]


def object_pose(task, rng, tilt: float = 0.0) -> np.ndarray:
    """The robot standing at the origin, its arm at the task's reset, and the
    object against its front feet: the box upright, the tire of
    spot_tire_roll upright, the tire of spot_tire_upright as its reset lays
    it, flat (body quat (1, +-1, 0, 0)/sqrt(2) turned by a random yaw, which
    keeps its axis along z), or with ``tilt`` tipped by that angle about the
    x axis onto its rim, as in the middle of a flip; each a few cm from its
    place and 5 mm into the ground (a contact at zero distance is active or
    not by the rounding of the operations)."""
    from judo_tpu_torch.tasks.spot import spot_constants as sc

    robot = np.r_[0.0, 0.0, sc.STANDING_HEIGHT, 1, 0, 0, 0, sc.LEGS_STANDING_POS, task.reset_arm_pos]
    dx, dy = 0.03 * rng.standard_normal(2)
    sink = 0.005
    if task.name == "spot_box_push":
        obj = [0.6 + dx, dy, sc.BOX_HALF_LENGTH - sink, 1, 0, 0, 0]
    elif task.name == "spot_tire_roll":
        obj = [0.66 + dx, dy, sc.TIRE_RADIUS - sink, 1, 0, 0, 0]
    else:
        yaw, sign = rng.uniform(0, 2 * np.pi), rng.choice([-1.0, 1.0])
        c, s = np.cos(yaw / 2), np.sin(yaw / 2)
        w, x, y, z = np.array([c, sign * c, sign * s, s]) / np.sqrt(2)
        ct, st = np.cos(tilt / 2), np.sin(tilt / 2)  # (ct, st, 0, 0) * (w, x, y, z)
        quat = [ct * w - st * x, ct * x + st * w, ct * y - st * z, ct * z + st * y]
        height = sc.TIRE_RADIUS * np.sin(tilt) + sc.TIRE_HALF_WIDTH * np.cos(tilt) - sink
        obj = [0.66 + dx, dy, height, *quat]
    return np.r_[robot, obj]


def object_inputs(task, B: int, T: int, seed: int, dtype, device, tilt: float = TIRE_TILT):
    """K2's inputs on an object scene: object_pose per rollout (the tire of
    spot_tire_upright tipped by ``tilt``) with the robot's joints perturbed,
    small velocities, a random nonzero policy output, and walking commands
    with the arm at the task's reset."""
    from judo_tpu_torch.tasks.spot import spot_constants as sc

    rng = np.random.default_rng(seed)
    qp = np.stack([object_pose(task, rng, tilt) for _ in range(B)], axis=1)
    qp[7:26] += 0.05 * rng.standard_normal((19, B))
    qv = 0.05 * rng.standard_normal((task.nv, B))
    po = 0.3 * rng.standard_normal((12, B))
    cmd = np.zeros((T, 25, B))
    cmd[:, :3] = 0.5 * rng.standard_normal((T, 3, B))
    cmd[:, 3:10] = task.reset_arm_pos[None, :, None]
    cmd[:, 24] = sc.STANDING_HEIGHT_CMD
    return [tensor(x, dtype, device) for x in (qp, qv, po, cmd)]


def spot_task(scene: str, dtype):
    from judo_tpu_torch.tasks import get_registered_tasks

    return get_registered_tasks()[scene][0](device="cuda", dtype=dtype)


def max_errs(names, ref, out) -> dict:
    return {n: float((a - b).abs().max()) for n, a, b in zip(names, ref, out)}


def split_distance_errs(m, err: dict, ref_sens, out_sens, plain64=None) -> None:
    """Where the model has distance sensors: their error apart from the other
    sensors' ("distance"), and, given ``plain64`` (the plain version's sensors
    in float64 on the same inputs), the plain float32 version's own error on
    them ("distance_plain_f32_vs_f64"). Sensor rows are axis -2."""
    from judo_tpu_torch.physics.model import SENSOR_DISTANCE

    rows = [m.sensor_adr[i] for i in range(m.nsensor) if m.sensor_type[i] == SENSOR_DISTANCE]
    if not rows:
        return
    other = [k for k in range(ref_sens.shape[-2]) if k not in rows]
    err["sensors"] = float((ref_sens[..., other, :] - out_sens[..., other, :]).abs().max())
    err["distance"] = float((ref_sens[..., rows, :] - out_sens[..., rows, :]).abs().max())
    if plain64 is not None:
        err["distance_plain_f32_vs_f64"] = float((plain64[..., rows, :] - ref_sens[..., rows, :].double()).abs().max())


def k1_vs_plain(dtype_name: str, B: int = B_MAIN, scene: str = "leap") -> dict:
    import torch

    from judo_tpu_torch.physics.fused_rollout import fused_rollout, num_constraint_rows, rollout_lanes_reference

    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    m = scene_model(scene, dtype)
    qp, qv, ct = scene_inputs(scene, m, B, T_CHECK + 1, seed=1, dtype=dtype, device="cuda")
    zeros = torch.zeros((num_constraint_rows(m), B), dtype=dtype, device="cuda")
    # onset forces from one plain step: the carried warm start of a real solve
    f0 = rollout_lanes_reference(m, qp, qv, ct[:1], zeros, 1, 8)[3]
    ref = rollout_lanes_reference(m, qp, qv, ct[1:], f0, 1, 8)
    out = fused_rollout(m, qp, qv, ct[1:].contiguous(), f0, 1, 8)
    torch.cuda.synchronize()
    err = max_errs(("states", "qvel", "sensors", "efc0"), ref, out)
    err["states"] = max(err["states"], err.pop("qvel"))
    scale = float(ref[3].abs().max())
    err["efc0_rel"] = err["efc0"] / max(scale, 1e-30)
    err["efc0_scale"] = scale
    plain64 = None
    if dtype == torch.float32:
        d = torch.float64
        plain64 = rollout_lanes_reference(scene_model(scene, d), qp.to(d), qv.to(d), ct[1:].to(d), f0.to(d), 1, 8)[2]
    split_distance_errs(m, err, ref[2], out[2], plain64)
    return err


def k2_vs_plain(dtype_name: str, B: int, scene: str = "spot_navigate", ticks: int = T_POLICY_CHECK,
                tilt: float = TIRE_TILT) -> dict:
    """K2 against its plain version over ``ticks`` policy ticks (the tire of
    spot_tire_upright tipped by ``tilt``); on an object scene in float32 also
    the plain version's own float32 vs float64 error on the same inputs
    ("states_plain_f32_vs_f64")."""
    import torch

    from judo_tpu_torch.physics.policy_rollout import fused_policy_rollout, policy_rollout_lanes_reference

    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    task = spot_task(scene, dtype)
    if scene == "spot_navigate":
        args = spot_inputs(task, B, ticks, seed=5, dtype=dtype, device="cuda")
    else:
        args = object_inputs(task, B, ticks, seed=5, dtype=dtype, device="cuda", tilt=tilt)
    ref = policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8)
    out = fused_policy_rollout(task.planning_model, task.policy, *args, 2, 8)
    torch.cuda.synchronize()
    err = max_errs(("states", "qvel", "sensors", "pout"), ref, out)
    err["states"] = max(err["states"], err.pop("qvel"))
    if dtype == torch.float32 and scene != "spot_navigate":
        d = torch.float64
        t64 = spot_task(scene, d)
        ref64 = policy_rollout_lanes_reference(t64.planning_model, t64.policy, *(a.to(d) for a in args), 2, 8)
        err["states_plain_f32_vs_f64"] = max(float((a.double() - b).abs().max()) for a, b in zip(ref[:2], ref64[:2]))
    return err


def k3_vs_plain(dtype_name: str, scene: str) -> dict:
    import torch

    from judo_tpu_torch.physics.fused_rollout import num_constraint_rows, physics_step, physics_step_reference
    from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    if scene in ("leap", "fr3"):
        m = scene_model(scene, dtype)
        qp, qv, ct = scene_inputs(scene, m, K3_B[scene], 1, seed=6, dtype=dtype, device="cuda")
        ctrl = ct[0]
    else:
        task = SpotNavigate(device="cuda", dtype=dtype)
        m = task.planning_model
        qp, qv, _, _ = spot_inputs(task, R_SPOT, 1, seed=7, dtype=dtype, device="cuda")
        ctrl = tensor(np.tile(np.r_[task.qpos[7:26]][:, None], (1, R_SPOT)), dtype, "cuda")
    f = torch.zeros((num_constraint_rows(m), qp.shape[-1]), dtype=dtype, device="cuda")
    ref = physics_step_reference(m, qp, qv, ctrl, f, 8)
    out = physics_step(m, qp, qv, ctrl, f, 8)
    torch.cuda.synchronize()
    err = max_errs(("states", "qvel", "sensors", "efc"), ref, out)
    err["states"] = max(err["states"], err.pop("qvel"))
    scale = float(ref[3].abs().max())
    err["efc_rel"] = err["efc"] / max(scale, 1e-30)
    plain64 = None
    if dtype == torch.float32 and scene == "fr3":
        d = torch.float64
        plain64 = physics_step_reference(scene_model(scene, d), qp.to(d), qv.to(d), ctrl.to(d), f.to(d), 8)[2]
    split_distance_errs(m, err, ref[2], out[2], plain64)
    return err


def reset_counts() -> None:
    from judo_tpu_torch.physics.fused_rollout import fused_rollout, physics_step
    from judo_tpu_torch.physics.policy_rollout import fused_policy_rollout

    fused_rollout.launches = fused_policy_rollout.launches = physics_step.launches = 0


def read_counts() -> dict:
    from judo_tpu_torch.physics.fused_rollout import fused_rollout, physics_step
    from judo_tpu_torch.physics.policy_rollout import fused_policy_rollout

    return {"fused_rollout": fused_rollout.launches, "fused_policy_rollout": fused_policy_rollout.launches,
            "physics_step": physics_step.launches}


def drive(c, warmup: int, timed: int, perturbed) -> tuple[list, dict]:
    """update_action calls on perturbed states; -> (timed ms, launch counts of the timed run)."""
    import torch

    for _ in range(warmup):
        c.current_state = perturbed()
        c.update_action()
    torch.cuda.synchronize()
    times = []
    reset_counts()
    for _ in range(timed):
        c.current_state = perturbed()
        t0 = time.perf_counter()
        c.update_action()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    counts = read_counts()
    lo, hi = c.task.actuator_ctrlrange[:, 0], c.task.actuator_ctrlrange[:, 1]
    knots = np.asarray(c.nominal_knots)
    if not np.all(np.isfinite(c.rewards)) or c.rewards.shape != (c.optimizer_cfg.num_rollouts,):
        raise RuntimeError(f"rewards not finite or wrong shape: {c.rewards.shape}")
    if not np.all(np.isfinite(knots)) or np.any(knots < lo - 1e-6) or np.any(knots > hi + 1e-6):
        raise RuntimeError("nominal knots not finite or outside the control range")
    return times, counts


def leap_path() -> dict:
    import torch

    from judo_tpu_torch.controller import make_controller
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

    times, counts = drive(c, 3, 10, perturbed)
    if counts["fused_rollout"] != 10:
        raise RuntimeError(f"fused_rollout launches {counts} != 10 solves")
    return {"counts": counts, "p50_ms": float(np.percentile(times, 50)), "p95_ms": float(np.percentile(times, 95)),
            "reward_max": float(c.rewards.max()), "reward_min": float(c.rewards.min())}


def spot_path() -> dict:
    import torch

    from judo_tpu_torch.controller import make_controller

    c = make_controller("spot_navigate", "mppi", device="cuda", dtype=torch.float32, seed=0)
    if (c.optimizer_cfg.num_rollouts, c.num_timesteps, c.task.physics_substeps) != (R_SPOT, T_FULL, 2):
        raise RuntimeError("spot_navigate defaults are not R 24, T 100, 2 substeps")
    c.task.config.goal_position = np.array([1.5, 0.5, 0.52])
    rng = np.random.default_rng(3)
    base = np.concatenate([c.task.qpos, np.zeros(c.pm.nv)])

    def perturbed():
        s = base.copy()
        s[c.pm.nq :] += 0.02 * rng.standard_normal(c.pm.nv)
        return s

    times, counts = drive(c, 1, 5, perturbed)
    if counts["fused_policy_rollout"] != 5:
        raise RuntimeError(f"fused_policy_rollout launches {counts} != 5 solves")
    return {"counts": counts, "p50_ms": float(np.percentile(times, 50)), "p95_ms": float(np.percentile(times, 95)),
            "reward_max": float(c.rewards.max()), "reward_min": float(c.rewards.min())}


def cylinder_push_path() -> dict:
    """The CLI's default: cylinder_push planned with predictive sampling."""
    import torch

    from judo_tpu_torch.controller import make_controller

    c = make_controller("cylinder_push", "ps", device="cuda", dtype=torch.float32, seed=0)
    if (c.optimizer_cfg.num_rollouts, c.num_timesteps) != (32, 52):
        raise RuntimeError("cylinder_push + ps defaults are not R 32, T 52")
    rng = np.random.default_rng(4)
    base = np.concatenate([CYLINDER_PUSH_CONTACT, np.zeros(c.pm.nv)])

    def perturbed():
        s = base.copy()
        s[:4] += 0.02 * rng.standard_normal(4)
        s[4:] += 0.1 * rng.standard_normal(4)
        return s

    times, counts = drive(c, 3, 10, perturbed)
    if counts["fused_rollout"] != 10:
        raise RuntimeError(f"fused_rollout launches {counts} != 10 solves")
    return {"counts": counts, "p50_ms": float(np.percentile(times, 50)), "p95_ms": float(np.percentile(times, 95)),
            "reward_max": float(c.rewards.max()), "reward_min": float(c.rewards.min()), "R": 32, "T": c.num_timesteps}


def fr3_path() -> dict:
    """fr3_pick planned with the cross-entropy method."""
    import torch

    from judo_tpu_torch.controller import make_controller

    c = make_controller("fr3_pick", "cem", device="cuda", dtype=torch.float32, seed=0)
    if (c.optimizer_cfg.num_rollouts, c.num_timesteps) != (64, 252):
        raise RuntimeError("fr3_pick + cem defaults are not R 64, T 252")
    rng = np.random.default_rng(5)
    base = np.concatenate([c.task.qpos, np.zeros(c.pm.nv)])

    def perturbed():
        s = base.copy()
        s[7:14] += 0.01 * rng.standard_normal(7)
        s[c.pm.nq :] += 0.02 * rng.standard_normal(c.pm.nv)
        return s

    times, counts = drive(c, 1, 5, perturbed)
    if counts["fused_rollout"] != 5:
        raise RuntimeError(f"fused_rollout launches {counts} != 5 solves")
    return {"counts": counts, "p50_ms": float(np.percentile(times, 50)), "p95_ms": float(np.percentile(times, 95)),
            "reward_max": float(c.rewards.max()), "reward_min": float(c.rewards.min()), "R": 64, "T": c.num_timesteps,
            "phase": c.task.phase.name}


def object_task_path(name: str) -> dict:
    """A Spot object task planned with MPPI at its defaults, from the task's
    own reset (seeded): the object 1-2 m from the robot, the tire of
    spot_tire_upright lying flat."""
    import torch

    from judo_tpu_torch.controller import make_controller

    np.random.seed(0)
    c = make_controller(name, "mppi", device="cuda", dtype=torch.float32, seed=0)
    cfg = c.optimizer_cfg
    if (cfg.num_rollouts, cfg.num_nodes, c.horizon, c.num_timesteps, c.task.physics_substeps) != (R_SPOT, 3, 2.0,
                                                                                                     T_FULL, 2):
        raise RuntimeError(f"{name} + mppi defaults are not R 24, 3 knots, 2 s, T 100 x 2")
    rng = np.random.default_rng(6)
    base = np.concatenate([c.task.qpos, np.zeros(c.pm.nv)])

    def perturbed():
        s = base.copy()
        s[c.pm.nq :] += 0.02 * rng.standard_normal(c.pm.nv)
        return s

    times, counts = drive(c, 1, 5, perturbed)
    if counts["fused_policy_rollout"] != 5:
        raise RuntimeError(f"fused_policy_rollout launches {counts} != 5 solves")
    return {"counts": counts, "p50_ms": float(np.percentile(times, 50)), "p95_ms": float(np.percentile(times, 95)),
            "reward_max": float(c.rewards.max()), "reward_min": float(c.rewards.min())}


def depth_path(task_name: str, R: int, warmup: int, timed: int) -> dict:
    """Plan times at pipeline_depth 0 and 2, as bench.py takes them: the host
    time of each update_action on freshly perturbed states, without a sync
    after the call. Each depth starts from a reset controller and runs the
    same states, ``warmup`` calls (at depth 2 they fill the pipeline) and
    ``timed`` timed ones. At depth 2 each call must return before the card
    has run the solve it dispatched (the event that ends the solve's mirror
    copy has not fired), and once flushed the run must have published what
    depth 0 published, bitwise: the carry chains on the card as it does
    unpipelined. The runs are short: from one standing state, a sampled Spot
    rollout diverges after some 30 solves, in the plain version as in the
    kernel, and its non-finite reward then spoils the plan (ROADMAP queue 3).
    One more depth-2 call runs under torch.cuda.set_sync_debug_mode("warn");
    its warnings name every operation on the dispatch path that waits for the
    card that PyTorch can see."""
    import warnings

    import torch

    from judo_tpu_torch.controller import make_controller
    from judo_tpu_torch.tasks.leap_cube import QPOS_REST

    c = make_controller(task_name, "mppi", device="cuda", dtype=torch.float32, seed=0)
    c.optimizer_cfg.num_rollouts = R
    if task_name == "spot_navigate":
        c.task.config.goal_position = np.array([1.5, 0.5, 0.52])
        base = np.concatenate([c.task.qpos, np.zeros(c.pm.nv)])
    else:
        base = np.concatenate([QPOS_REST, np.zeros(c.pm.nv)])
    out: dict = {}

    def run(depth: int) -> tuple:
        c.reset()
        c.controller_cfg.pipeline_depth = depth
        rng = np.random.default_rng(7)
        times, dispatch, early = [], [], 0
        for k in range(warmup + timed):
            c.current_state = base + np.r_[np.zeros(c.pm.nq), 0.02 * rng.standard_normal(c.pm.nv)]
            if k == warmup:
                reset_counts()
            t0 = time.perf_counter()
            c.update_action()
            if k < warmup:
                continue
            times.append(1e3 * (time.perf_counter() - t0))
            if depth:
                early += not c._pending[-1].ready.query()
                dispatch.append(c.last_plan_timing["device_ms"])
        out[depth] = {"p50_ms": float(np.percentile(times, 50)), "p95_ms": float(np.percentile(times, 95)),
                      "early": early, "calls": timed, "counts": read_counts()}
        if depth:
            out[depth]["dispatch_p50_ms"] = float(np.percentile(dispatch, 50))
        c.flush_pipeline()
        return c.rewards.copy(), np.asarray(c.nominal_knots).copy()

    ref, piped = run(0), run(2)
    out["same"] = all(np.array_equal(a, b) for a, b in zip(ref, piped))
    out["finite"] = all(bool(np.all(np.isfinite(a))) for a in ref)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            c.update_action()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["syncs"] = [str(w.message).splitlines()[0] for w in caught if "prototype" not in str(w.message)]
    c.flush_pipeline()
    torch.cuda.synchronize()
    return out


def step_path() -> dict:
    import torch

    from judo_tpu_torch.physics.fused_rollout import num_constraint_rows, physics_step
    from judo_tpu_torch.tasks.leap_cube import LeapCube

    m = LeapCube(device="cuda", dtype=torch.float32).planning_model
    qp, qv, ct = leap_inputs(m, B_MAIN, 1, seed=8, dtype=torch.float32, device="cuda")
    f = torch.zeros((num_constraint_rows(m), B_MAIN), dtype=torch.float32, device="cuda")
    reset_counts()
    out = physics_step(m, qp, qv, ct[0], f, 8)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["physics_step"] != 1 or not all(bool(torch.isfinite(x).all()) for x in out):
        raise RuntimeError(f"single step: launches {counts}, finite {[bool(torch.isfinite(x).all()) for x in out]}")
    return {"counts": counts}


def solve_gpu_vs_cpu(task_name: str, opt_name: str, R: int, horizon: float) -> float:
    """One float64 solve with shared noise: cuda vs cpu, largest error of rewards and knots."""
    import torch

    from judo_tpu_torch.controller import make_controller

    out = {}
    for dev in ("cpu", "cuda"):
        np.random.seed(0)  # the same random reset pose on both devices
        c = make_controller(task_name, opt_name, device=dev, dtype=torch.float64, seed=0)
        c.optimizer_cfg.num_rollouts = R
        c.controller_cfg.horizon = horizon
        noise = np.random.default_rng(3).standard_normal((R - 1, c.optimizer_cfg.num_nodes, c.task.nu))
        opt = c.optimizer
        opt.sample = lambda p, s, nom, g, opt=opt, noise=noise: opt.sample_from_noise(
            p, s, nom, torch.as_tensor(noise, dtype=nom.dtype, device=nom.device)
        )
        if task_name == "leap_cube":
            from judo_tpu_torch.tasks.leap_cube import QPOS_REST

            c.current_state = np.concatenate([QPOS_REST, np.zeros(c.pm.nv)])
        elif task_name == "cylinder_push":
            c.current_state = np.concatenate([CYLINDER_PUSH_CONTACT, np.zeros(c.pm.nv)])
        c.update_action()
        out[dev] = (c.rewards.copy(), np.asarray(c.nominal_knots).copy())
    return float(max(np.abs(out["cpu"][0] - out["cuda"][0]).max(), np.abs(out["cpu"][1] - out["cuda"][1]).max()))


def event_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, CUDA events, after
    one warm-up call unless ``warmup`` is False."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def step_flops(m, iterations: int, cold: bool) -> float:
    """Floating-point operations of one physics step of one rollout, counted
    from the step body's loops: every pass over the dense (nefc x nv) J
    (assembly ~20 per element, masking, b, Jacobi scaling, two passes per
    operator apply, the final J^T f), the island inverses of M and M + hD,
    the island mat-vecs of every apply, and the APGD vector updates."""
    from judo_tpu_torch.physics.fused_rollout import num_constraint_rows, solver_iters
    from judo_tpu_torch.physics.lane_engine import dof_islands

    ne, nv, it = num_constraint_rows(m), m.nv, solver_iters(m, iterations)
    applies = it + 1 + (3 if cold else 0)
    k = [e - s for s, e in dof_islands(m)]
    return (ne * nv * (4 * applies + 27) + sum(4 * x**3 + 2 * x * x * (applies + 3) for x in k) + 12 * ne * it)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = 1e3 * nbytes / PEAK_BYTES, 1e3 * flops / PEAK_F32
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def timing() -> dict:
    import torch

    from judo_tpu_torch.physics.fused_rollout import (
        fused_rollout, num_constraint_rows, physics_step, physics_step_reference, rollout_lanes_reference,
    )
    from judo_tpu_torch.physics.policy_rollout import fused_policy_rollout, policy_rollout_lanes_reference
    from judo_tpu_torch.tasks.leap_cube import LeapCube
    from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

    f32, res = torch.float32, {}
    m = LeapCube(device="cuda", dtype=f32).planning_model
    ne = num_constraint_rows(m)
    qp, qv, ct = leap_inputs(m, B_MAIN, T_FULL, seed=4, dtype=f32, device="cuda")
    f0 = torch.zeros((ne, B_MAIN), dtype=f32, device="cuda")
    k1 = event_ms(lambda: fused_rollout(m, qp, qv, ct, f0, 1, 8), 10)
    k1_plain = event_ms(lambda: rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8), 1, warmup=False)
    io = 4 * B_MAIN * (m.nq + m.nv + 2 * ne + T_FULL * (m.nu + m.nq + m.nv + m.nsensordata))
    res["fused_rollout"] = (k1, k1_plain, *bound_ms(io, B_MAIN * T_FULL * step_flops(m, 8, False)))
    k3 = event_ms(lambda: physics_step(m, qp, qv, ct[0], f0, 8), 50)
    k3_plain = event_ms(lambda: physics_step_reference(m, qp, qv, ct[0], f0, 8), 3)
    io = 4 * B_MAIN * (2 * (m.nq + m.nv + ne) + m.nu + m.nsensordata)
    res["physics_step"] = (k3, k3_plain, *bound_ms(io, B_MAIN * step_flops(m, 8, True)))

    task = SpotNavigate(device="cuda", dtype=f32)
    sm, pol = task.planning_model, task.policy
    args = spot_inputs(task, R_SPOT, T_FULL, seed=9, dtype=f32, device="cuda")
    k2 = event_ms(lambda: fused_policy_rollout(sm, pol, *args, 2, 8), 5)
    k2_plain = event_ms(lambda: policy_rollout_lanes_reference(sm, pol, *args, 2, 8), 1, warmup=False)
    dims = pol.dims
    mlp = 2 * sum((dims[i] + 1) * dims[i + 1] for i in range(len(dims) - 1))
    weights = 4 * sum((dims[i] + 1) * dims[i + 1] for i in range(len(dims) - 1))
    io = weights + 4 * R_SPOT * (sm.nq + sm.nv + 12 + T_FULL * (25 + sm.nq + sm.nv + sm.nsensordata + 12))
    res["fused_policy_rollout"] = (
        k2, k2_plain, *bound_ms(io, R_SPOT * T_FULL * (mlp + 2 * step_flops(sm, 8, False)))
    )
    # K1 at the shapes of the cylinder_push and fr3_pick paths
    for scene, B, T, reps in (("cylinder_push", 32, 52, 20), ("fr3", 64, 252, 5)):
        m = scene_model(scene, f32)
        ne = num_constraint_rows(m)
        qp, qv, ct = scene_inputs(scene, m, B, T, seed=10, dtype=f32, device="cuda")
        f0 = torch.zeros((ne, B), dtype=f32, device="cuda")
        ms = event_ms(lambda: fused_rollout(m, qp, qv, ct, f0, 1, 8), reps)
        plain = event_ms(lambda: rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8), 1, warmup=False)
        io = 4 * B * (m.nq + m.nv + 2 * ne + T * (m.nu + m.nq + m.nv + m.nsensordata))
        res[f"fused_rollout {scene} B={B} T={T}"] = (ms, plain, *bound_ms(io, B * T * step_flops(m, 8, False)))
    # the same launch with no physics substeps: observation, MLP and ctrl only
    res["k2_policy_only_ms"] = event_ms(lambda: fused_policy_rollout(sm, pol, *args, 0, 8), 5)
    # K2 at the object tasks' plan shape; the plain version over 3 ticks
    for scene in OBJECT_TASKS:
        task = spot_task(scene, f32)
        om, opol = task.planning_model, task.policy
        oargs = object_inputs(task, R_SPOT, T_FULL, seed=11, dtype=f32, device="cuda")
        ms = event_ms(lambda: fused_policy_rollout(om, opol, *oargs, 2, 8), 5)
        short = [a[:T_POLICY_CHECK] if a.dim() == 3 else a for a in oargs]
        plain = event_ms(lambda: policy_rollout_lanes_reference(om, opol, *short, 2, 8), 1, warmup=False)
        io = weights + 4 * R_SPOT * (om.nq + om.nv + 12 + T_FULL * (25 + om.nq + om.nv + om.nsensordata + 12))
        bnd = bound_ms(io, R_SPOT * T_FULL * (mlp + 2 * step_flops(om, 8, False)))
        res[f"k2 {scene}"] = (ms, plain / T_POLICY_CHECK, *bnd)
    return res


def occupancy_report() -> list:
    """Scratch layout, dynamic shared memory per block and resident blocks
    per SM of each kernel at the paths' models, float32 and float64."""
    import torch

    from judo_tpu_torch.physics.fused_rollout import kernel_layout

    lines = []
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        leap, cyl, fr3 = (scene_model(s, dtype) for s in ("leap", "cylinder_push", "fr3"))
        rows = [("fused_rollout leap", leap, False, None), ("physics_step leap", leap, True, None),
                ("fused_rollout cylinder_push", cyl, False, None), ("fused_rollout fr3", fr3, False, None),
                ("physics_step fr3", fr3, True, None)]
        for scene in ("spot_navigate", *OBJECT_TASKS):
            task = spot_task(scene, dtype)
            rows.append((f"fused_policy_rollout {scene}", task.planning_model, False, task.policy))
        for kernel, m, cold, policy in rows:
            layout, nbytes, blocks = kernel_layout(m, dtype, cold, policy)
            lines.append(f"{kernel} {name}: layout {layout}, {nbytes} B dynamic shared memory per block, {blocks} "
                         f"blocks per SM")
    return lines


def build_report(log: str) -> list:
    """ptxas lines naming each kernel's registers and spills."""
    keep = []
    for line in log.splitlines():
        if any(k in line for k in ("Compiling entry function", "Function properties", "registers", "spill",
                                   "build seconds")):
            keep.append(line.strip())
    return keep


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
    for line in build_report(_build.build_log("cuda")):
        print(f"  {line}")
    for line in occupancy_report():
        print(f"  {line}", flush=True)

    errs, ok = {}, True

    def check(label: str, value: float, limit: float) -> None:
        nonlocal ok
        good = value <= limit
        ok &= good
        print(f"{label}: max err {value:.3e} limit {limit:.0e} {'ok' if good else 'FAIL'}", flush=True)

    def check_distance(label: str, name: str, e: dict) -> None:
        if "distance" not in e:
            return
        if name == "f64":
            check(f"{label} distance sensors", e["distance"], LIMITS["f64"])
        else:
            check(f"{label} distance sensors (the plain version's own f32 vs f64 error on them "
                  f"{e['distance_plain_f32_vs_f64']:.3e})", e["distance"], LIMITS["f32_distance"])

    for scene in ("leap", "cylinder_push", "fr3"):
        for name in ("f64", "f32"):
            for B in K1_B[scene]:
                e = errs[("fused_rollout", name, scene, B)] = k1_vs_plain(name, B, scene)
                lim = LIMITS[name]
                for k in ("states", "sensors"):
                    check(f"fused_rollout vs plain {name} {scene} B={B} T={T_CHECK} {k}", e[k], lim)
                check_distance(f"fused_rollout vs plain {name} {scene} B={B} T={T_CHECK}", name, e)
                if name == "f64":
                    check(f"fused_rollout vs plain f64 {scene} B={B} efc0", e["efc0"], lim)
                else:
                    check(f"fused_rollout vs plain f32 {scene} B={B} efc0 relative (|efc0| max "
                          f"{e['efc0_scale']:.3e})", e["efc0_rel"], LIMITS["f32_efc0_rel"])
    for name in ("f64", "f32"):
        for B in (R_SPOT, 80):
            e = errs[("fused_policy_rollout", name, "spot_navigate", B)] = k2_vs_plain(name, B)
            for k in ("states", "sensors", "pout"):
                check(f"fused_policy_rollout vs plain {name} spot B={B} T={T_POLICY_CHECK} {k}", e[k], LIMITS[name])
        for scene in OBJECT_TASKS:
            e = errs[("fused_policy_rollout", name, scene, R_SPOT)] = k2_vs_plain(name, R_SPOT, scene)
            own = "" if name == "f64" else (f" (the plain version's own f32 vs f64 error "
                                            f"{e['states_plain_f32_vs_f64']:.3e})")
            tipped = f" tire tipped {TIRE_TILT} rad" if scene == "spot_tire_upright" else ""
            for k in ("states", "sensors", "pout"):
                check(f"fused_policy_rollout vs plain {name} {scene}{tipped} B={R_SPOT} T={T_POLICY_CHECK} {k}"
                      f"{own if k == 'states' else ''}", e[k], LIMITS[name])
        e = errs[("fused_policy_rollout", name, "flat tire", R_SPOT)] = k2_vs_plain(
            name, R_SPOT, "spot_tire_upright", T_FLAT, tilt=0.0)
        label = f"fused_policy_rollout vs plain {name} spot_tire_upright tire flat B={R_SPOT} T={T_FLAT}"
        if name == "f64":
            for k in ("states", "sensors", "pout"):
                check(f"{label} {k}", e[k], LIMITS["f64"])
        else:
            own = e["states_plain_f32_vs_f64"]
            check(f"{label} states (the plain version's own f32 vs f64 error {own:.3e}; limit twice that)",
                  e["states"], max(LIMITS["f32"], LIMITS["f32_flat_tire_vs_own"] * own))
    for name in ("f64", "f32"):
        for scene in ("leap", "spot", "fr3"):
            e = errs[("physics_step", name, scene)] = k3_vs_plain(name, scene)
            B = K3_B[scene]
            for k in ("states", "sensors"):
                check(f"physics_step vs plain {name} {scene} B={B} {k}", e[k], LIMITS[name])
            check_distance(f"physics_step vs plain {name} {scene} B={B}", name, e)
            if name == "f64":
                check(f"physics_step vs plain f64 {scene} efc", e["efc"], LIMITS["f64"])
            else:
                check(f"physics_step vs plain f32 {scene} efc relative", e["efc_rel"], LIMITS["f32_efc0_rel"])

    card = card_info()
    leap = leap_path()
    print(f"path leap_cube mppi R={B_MAIN} T={T_FULL} f32: p50 {leap['p50_ms']:.2f} ms p95 {leap['p95_ms']:.2f} ms "
          f"launches {leap['counts']} in 10 solves, rewards [{leap['reward_min']:.4f}, {leap['reward_max']:.4f}] "
          f"on {card}", flush=True)
    spot = spot_path()
    print(f"path spot_navigate mppi R={R_SPOT} T={T_FULL}x2 f32: p50 {spot['p50_ms']:.2f} ms p95 "
          f"{spot['p95_ms']:.2f} ms launches {spot['counts']} in 5 solves, rewards [{spot['reward_min']:.4f}, "
          f"{spot['reward_max']:.4f}] on {card}", flush=True)
    step = step_path()
    print(f"path physics_step leap B={B_MAIN} f32: launches {step['counts']}", flush=True)
    new_paths = {}
    for label, fn in (("cylinder_push ps", cylinder_push_path), ("fr3_pick cem", fr3_path)):
        p = new_paths[label] = fn()
        print(f"path {label} R={p['R']} T={p['T']} f32: p50 {p['p50_ms']:.2f} ms p95 {p['p95_ms']:.2f} ms "
              f"launches {p['counts']} in {p['counts']['fused_rollout']} solves, rewards [{p['reward_min']:.4f}, "
              f"{p['reward_max']:.4f}]{' phase ' + p['phase'] if 'phase' in p else ''} on {card}", flush=True)

    for label in OBJECT_TASKS:
        p = new_paths[label] = object_task_path(label)
        print(f"path {label} mppi R={R_SPOT} T={T_FULL}x2 f32: p50 {p['p50_ms']:.2f} ms p95 {p['p95_ms']:.2f} ms "
              f"launches {p['counts']} in 5 solves, rewards [{p['reward_min']:.4f}, {p['reward_max']:.4f}] on {card}",
              flush=True)
    for task_name, R in (("leap_cube", B_MAIN), ("spot_navigate", R_SPOT)):
        d = depth_path(task_name, R, 5, 20)
        d0, d2 = d[0], d[2]
        kernel = "fused_rollout" if task_name == "leap_cube" else "fused_policy_rollout"
        print(f"pipelining {task_name} mppi R={R} f32, 5 + 20 calls: depth 0 p50 {d0['p50_ms']:.2f} ms p95 "
              f"{d0['p95_ms']:.2f} ms; depth 2 p50 {d2['p50_ms']:.2f} ms p95 {d2['p95_ms']:.2f} ms, dispatch p50 "
              f"{d2['dispatch_p50_ms']:.2f} ms, {d2['early']} of {d2['calls']} calls returned before their solve "
              f"ended, launches {d2['counts'][kernel]}; flushed mirrors equal depth 0's bitwise: {d['same']}, finite: "
              f"{d['finite']} on {card}", flush=True)
        for msg in d["syncs"]:
            print(f"  sync on the depth-2 dispatch path: {msg}")
        good = d2["early"] == d2["calls"] == d2["counts"][kernel] == d0["counts"][kernel] and d["same"] and d["finite"]
        good &= not d["syncs"]
        ok &= good
        print(f"pipelining {task_name}: every depth-2 call launched its kernel and returned before its solve ended, "
              f"the flushed mirrors are finite and equal depth 0's, and nothing on the dispatch path waited for the "
              f"card: {'ok' if good else 'FAIL'}", flush=True)
    for task_name, opt_name, R, horizon in (("leap_cube", "mppi", 16, 0.2), ("spot_navigate", "mppi", 4, 0.4),
                                            ("cylinder_push", "ps", 8, 0.2), ("fr3_pick", "cem", 4, 0.032),
                                            ("spot_box_push", "mppi", 4, 0.4)):
        d = solve_gpu_vs_cpu(task_name, opt_name, R, horizon)
        check(f"solve f64 {task_name} {opt_name} R={R} horizon {horizon} s cuda vs cpu (shared noise)", d,
              LIMITS["solve_f64"])

    t = timing()
    for name, (ms, plain, bnd, by) in ((k, v) for k, v in t.items() if isinstance(v, tuple) and k[:3] != "k2 "):
        print(f"time {name} f32: kernel {ms:.3f} ms, plain PyTorch {plain:.1f} ms, bound {bnd:.4f} ms "
              f"({by}) on {card}", flush=True)
    print(f"time fused_policy_rollout plain PyTorch per tick: {t['fused_policy_rollout'][1] / T_FULL:.1f} ms",
          flush=True)
    print(f"time fused_policy_rollout f32 with 0 physics substeps (observation, MLP, ctrl): "
          f"{t['k2_policy_only_ms']:.3f} ms on {card}", flush=True)
    for scene in OBJECT_TASKS:
        ms, tick, bnd, by = t[f"k2 {scene}"]
        print(f"time fused_policy_rollout {scene} R={R_SPOT} T={T_FULL}x2 f32: kernel {ms:.3f} ms, plain PyTorch "
              f"{tick:.1f} ms per tick, bound {bnd:.4f} ms ({by}) on {card}", flush=True)
    if not ok:  # every phase ran; a check that failed above fails the run
        print("a check failed: see the lines marked FAIL", file=sys.stderr)
        return 1

    launches = {"fused_rollout": leap["counts"]["fused_rollout"] + sum(p["counts"]["fused_rollout"]
                                                                       for p in new_paths.values()),
                "fused_policy_rollout": spot["counts"]["fused_policy_rollout"] + sum(
                    new_paths[s]["counts"]["fused_policy_rollout"] for s in OBJECT_TASKS),
                "physics_step": step["counts"]["physics_step"]}
    rows = [
        ("fused_rollout", "judo_tpu_torch/csrc/fused_rollout.cu", "judo_tpu/physics/pallas_step.py:162",
         max(e["states"] for k, e in errs.items() if k[0] == "fused_rollout" and k[1] == "f32")),
        ("fused_policy_rollout", "judo_tpu_torch/csrc/fused_policy_rollout.cu", "judo_tpu/physics/pallas_step.py:310",
         max(e["states"] for k, e in errs.items() if k[0] == "fused_policy_rollout" and k[1] == "f32"
             and k[2] != "flat tire")),
        ("physics_step", "judo_tpu_torch/csrc/fused_rollout.cu", "judo_tpu/physics/pallas_step.py:71",
         max(errs[("physics_step", "f32", s)]["states"] for s in K3_B)),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "max_abs_err": err, "ms": t[name][0], "plain_ms": t[name][1], "bound_ms": t[name][2],
         "bound_by": t[name][3], "library_ms": None}
        for name, src, rep, err in rows
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
