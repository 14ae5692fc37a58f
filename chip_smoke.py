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
     sensors) at 64 and 33; and 50 steps at 64 rollouts on the check scene
     (judo_tpu_torch/models/check_scene.py: sphere-sphere and sphere-capsule
     pairs, springs and actuator force limits on a free and a ball joint);
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
   - over each planning path's whole horizon (``full_horizon``): K1 on leap
     at 33 rollouts over T 100 from onset forces of one plain step, K2 on
     spot_navigate at 24 rollouts over 100 policy ticks of 2 steps, and K3
     chained 100 ticks at one environment from leap_cube's reset with its
     reset command held, each chain against the plain version's chain;
     float64 checked against 1e-8; float32 printed beside the plain
     version's own float32 vs float64 gap on the same seeded inputs, not checked
     (float32 trajectories that cross contacts part at rounding); then the
     phase's seconds;
4. paths, each driven with every launch count set to 0 just before it and
   read just after. Every plan runs through the controller's solve cache: on
   the card a CUDA graph per shape signature, captured at its first solve and
   replayed; a replay adds its kernels' launches to their counters:
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
     pipeline_depth 0 and 2 (leap also with an eager twin, timed only),
     5 + 20 calls each on the same states, as bench.py times them (host
     time of each update_action; at depth 2 in steady state); every depth-2
     call must return before the card has run the solve it dispatched, and
     the flushed depth-2 run must have published depth 0's mirrors, bitwise;
     one depth-2 call under torch.cuda.set_sync_debug_mode("warn"), whose
     warnings (each an operation that waits for the card) must be none;
   - the plant: 20 ticks of JTSimulation (K3 at a batch of one, on a CUDA
     stream of its own) on leap_cube from its reset, float64 and float32,
     each tick against the plain version on the card from the same state;
     one tick dispatched while a leap solve (320 rollouts, depth 2) is in
     flight, which must end before the solve does;
   - the closed loop: judo_tpu_torch.cli.main(["run", ...]) with the
     judo_tpu plant for 5 s, leap_cube + mppi (320 rollouts, set as a launch
     config's override sets them) and the CLI's default cylinder_push + ps,
     and leap once more with an eager twin's controller (timed only);
     K3 launches equal the plant's ticks, K1 launches the plans and the
     warm-up, every published state is finite, the run ends with "shutdown
     complete"; the plant's ticks are printed against those its wall time
     called for;
   - the harness: run_benchmark on leap_cube and cylinder_push with mppi and
     ps, the judo_tpu plant, 20 plans each, printed by format_table;
   - the GUI loop: cli.main(["run", ..., "--gui", "--gui-port", <a free
     port>]) for 8 s on leap_cube + mppi (320 rollouts) with the judo_tpu
     plant, and a websocket client (judo_tpu_torch/visualizers/websocket.py)
     in a process of its own, as a browser would be: the hello has leap's 21
     bodies; state messages arrive at 20 Hz or more, with finite poses that
     move and traces of shape (495, 2, 3); a "set" of MPPI's temperature is
     published as optimizer_config; "reset" reaches the plant; at 5 s a
     switch to cylinder_push brings a hello with its 4 bodies and plans go
     on; K3 launches equal the ticks and K1 launches the plans, the warm-up
     and the switch's first solve; the run ends with "shutdown complete".
     Printed: plan and tick percentiles, ticks against ticks due (the pace,
     not a check), overruns, states per second, the state message's build
     and encode time on the host, the hello's size, the switch's latency;
   - the solve graphs: leap_cube + mppi (320 rollouts), cylinder_push + ps,
     fr3_pick + cem and spot_navigate + mppi, float32, each beside an eager
     twin (the plain ``solve`` in place of the cache entry, the same seed):
     6 solves, bitwise equal in published times, knots, rewards and traces
     and in the carry, with a tune of temperature, sigma, a reward weight and
     the horizon within its bucket after the third (no new capture), then a
     change of noise_ramp (one new capture) and 2 more solves; the kernel's
     launches equal the solves; then 10 timed solves of each, graph and
     eager in turns. leap -> cylinder_push -> leap as new controllers: the
     return is a cache hit. Printed: each entry's graph memory pool;
   - the profile: judo_tpu_torch.utils.profiling.trace around 5 leap_cube +
     mppi solves at depth 0, 20 calls at depth 2 and 10 cylinder_push + ps
     solves, and the depth-0 segments again with eager twins, each
     update_action in its own "judo.plan" span; K1's kernel events in
     the Chrome trace must equal its launch counter, and per segment the
     card's busy share (the union of its kernel and copy intervals over the
     segment's window), idle share and kernel launches per solve are printed;
   - the mesh: make_controller(..., mesh=make_rollout_mesh(devices=[...])) over
     every visible card, or two shards on cuda:0 where one is visible, float32:
     leap_cube + mppi (320 rollouts, and 64, whose shards run K1 at four
     warps per rollout), spot_navigate + mppi and cylinder_push + ps, each
     beside an unsharded twin: 8 solves (a tune after the third) bitwise
     equal in published times, knots, rewards, traces and carry, the kernel
     launched once per shard and optimizer iteration (K1 at the whole
     batch's warps per rollout), then 10 timed
     solves of both in turns (plan p50 and p95, bytes between devices per
     solve, the entry's graphs and pool bytes); two shards on one card must
     plan leap within 1.15x the twin's p50 (their kernels overlap); a leap
     controller of 321 rollouts on a 2-shard mesh must raise ValueError;
     cli.main(["run", ..., "--mesh", "hybrid"]) for 3 s on leap_cube + mppi
     must print its "mesh:" line, launch K1 once per shard for each plan and
     the warm-up and K3 once per tick, and publish finite states (its pace
     printed, as the other loops'). With two or more cards also leap at 1056
     rollouts (two waves of K1 on one card) over one card and two, and a mesh
     of two processes (``--mesh-rank``, NCCL), each bitwise against the
     unsharded solve; with one card a line says these were not run;
5. one float64 solve per path, cuda against cpu with shared noise (leap and
   spot with MPPI, cylinder_push with PS, fr3_pick with CEM, spot_box_push
   with MPPI, whose float64 kernel runs with J in global memory);
6. timing with CUDA events: each kernel against its plain version, and its
   bound (the larger of its bytes over the memory rate and its operations
   over the float32 rate, counted from the shapes of this run); K1 also on
   cylinder_push (32 rollouts, T 52) and fr3_pick (64, T 252; its plain
   version timed over 25 steps and scaled to the horizon); K2 also with
   no physics substeps, which leaves the policy's share of a tick, and on the
   three object scenes at R 24, T 100 x 2 (their plain version timed over 3
   ticks); K3 at the plant's shape (leap, one environment, the model's own
   solver iterations), the shape of its row in the kernels line, and at 320
   rollouts.
A failed check is marked FAIL on its line; every phase still runs, and the
run then ends with one line on stderr naming each failed check with its
numbers, and exits 1. The depth-2 dispatch checks and the tick beside a
solve run with Python's cyclic collector paused (``gc_paused``); the ``gc:``
line counts the run's full collections. The last line is {"ok": true,
"device": {...}}.

``python3 chip_smoke.py --gui-client PORT SWITCH_AT`` is the GUI loop's
client, which the GUI phase starts itself; ``--mesh-rank RANK WORLD PORT
PATH`` is a process of the multi-process mesh, which the mesh phase starts.
``python3 chip_smoke.py --mesh`` runs the build and the mesh phase alone, on
every visible card.
"""

from __future__ import annotations

import contextlib
import gc
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
# Rollouts of K1 on leap in the full-horizon phase: one more than a warp.
B_FULL = 33
R_SPOT, T_POLICY_CHECK = 24, 3
# The Spot tasks with an object; K2 plans them all.
OBJECT_TASKS = ("spot_box_push", "spot_tire_roll", "spot_tire_upright")
# The tire of spot_tire_upright in K2's checks: tipped 0.5 rad onto its rim.
# Lying flat, its axis is along the ground's normal, where plane-cylinder's
# rim direction is rounding noise and the tire rests on one rim point, so
# the dynamics from there split apart at the rounding of the operations
# (section 6 of PERF.md): the flat tire has a check of its own, over 1 tick.
TIRE_TILT, T_FLAT = 0.5, 1
# Rollouts of the K1 checks per scene, and of the K3 check; the steps of the
# K1 checks per scene.
K1_B = {"leap": (B_MAIN, 33), "cylinder_push": (32, 33), "fr3": (64, 33), "check": (64,)}
K1_T = {"check": 50}
K3_B = {"leap": B_MAIN, "spot": R_SPOT, "fr3": 64}
# The plant phase: ticks of JTSimulation on leap_cube per dtype; the closed
# loops' length in seconds; the harness's plans per pair.
PLANT_TICKS, LOOP_SECONDS, HARNESS_SAMPLES = 20, 5, 20
# Steps of fr3_pick's plain version timed (its time scaled to T 252): the
# whole horizon took 67-109 s of the run.
FR3_PLAIN_STEPS = 25
# The closed loop's pace (section 2 of PERF.md): the plant's ticks against
# those its wall time called for. Printed as met or not, not a check: host
# timing on a shared machine is not a property of the kernels.
PACE_LIMIT = 0.99
# The GUI phase: the loop's length, when its client switches the task, the
# temperature it sets, the least rate of state messages (of the server's 30
# per second) and the shape of leap's traces in each: 1 elite (leap_cube's
# controller override sets max_num_traces 1) x 5 trace sensors x 99
# segments, each a pair of points.
GUI_SECONDS, GUI_SWITCH_AT, GUI_TEMPERATURE, GUI_MIN_HZ = 8, 5.0, 0.1234, 20.0
LEAP_TRACES = [495, 2, 3]
# The profile phase: (label, task, optimizer, rollouts, pipeline_depth, calls,
# eager) per segment (eager: the plain solve in place of the solve graph), and
# where its Chrome trace goes.
PROFILE_SEGMENTS = (("leap_cube mppi depth 0", "leap_cube", "mppi", B_MAIN, 0, 5, False),
                    ("leap_cube mppi depth 2", "leap_cube", "mppi", B_MAIN, 2, 20, False),
                    ("cylinder_push ps depth 0", "cylinder_push", "ps", 32, 0, 10, False),
                    ("leap_cube mppi depth 0 eager", "leap_cube", "mppi", B_MAIN, 0, 5, True),
                    ("cylinder_push ps depth 0 eager", "cylinder_push", "ps", 32, 0, 10, True))
PROFILE_DIR = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_profile"
# The graph phase: (task, optimizer, rollouts; None: the task's default) per
# pair of controllers, each through the solve cache and as an eager twin; the
# solves compared before the tune, after it and after noise_ramp's change; the
# timed solves of each; the reward weight each task's tune doubles (its path
# in the task's config); the rollouts of the switch-back check's controllers.
GRAPH_TASKS = (("leap_cube", "mppi", B_MAIN), ("cylinder_push", "ps", None), ("fr3_pick", "cem", None),
               ("spot_navigate", "mppi", None))
GRAPH_SOLVES, GRAPH_TUNE_AT, GRAPH_AFTER_RAMP, GRAPH_TIMED = 6, 3, 2, 10
REWARD_WEIGHT = {"leap_cube": ("w_rot",), "cylinder_push": ("w_cart_position",),
                 "fr3_pick": ("global_weights", "w_upright"), "spot_navigate": ("w_goal",)}
SWITCH_R = {"leap_cube": 256, "cylinder_push": 40}
# The mesh phase: (task, optimizer, rollouts; None: the task's default) of each
# controller sharded over the mesh beside its unsharded twin; the solves
# compared (the tune after the third) and the timed ones; the plan p50 that two
# shards on one card may reach against the twin's (1.85x where their kernels
# ran one after the other); the refused batch; the --mesh hybrid loop's
# seconds; the two-wave leap batch and the multi-process solves, where two or
# more cards are visible.
# leap at 64 rollouts: K1's shards at four warps per rollout (fused_rollout.rollout_warps)
MESH_TASKS = (("leap_cube", "mppi", B_MAIN), ("spot_navigate", "mppi", None), ("cylinder_push", "ps", None),
              ("leap_cube", "mppi", 64))
MESH_SOLVES, MESH_TUNE_AT, MESH_TIMED, MESH_OVERLAP_LIMIT = 8, 3, 10, 1.15
MESH_REFUSED_R, MESH_LOOP_SECONDS, MESH_WAVES_R, MESH_RANK_SOLVES = 321, 3, 1056, 8
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


@contextlib.contextmanager
def gc_paused():
    """Python's cyclic collector paused, after one collection, as ``timeit``
    pauses it. A full collection in a process of this size holds the
    interpreter for up to a quarter of a second, in whichever thread it
    starts (a controller's consumer thread too); a check of the host's timing
    against the card's would read that pause as a wait for the card."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def full_collections() -> list:
    """From now on, the length in ms of each full collection of Python's
    cyclic collector, appended to the list returned."""
    lengths, started = [], [0.0]

    def timer(phase: str, info: dict) -> None:
        if info["generation"] == 2:
            if phase == "start":
                started[0] = time.perf_counter()
            else:
                lengths.append(1e3 * (time.perf_counter() - started[0]))

    gc.callbacks.append(timer)
    return lengths


def pcts(ms) -> str:
    return f"p50 {np.percentile(ms, 50):.3f} ms p95 {np.percentile(ms, 95):.3f} ms"


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
    active contacts, and controls around the task's warm start (on the check
    scene: the free and ball joints turned from their springs' rest, the
    pusher near the pendulum's rod)."""
    if scene == "leap":
        return leap_inputs(m, B, T, seed, dtype, device)
    rng = np.random.default_rng(seed)
    if scene == "check":
        qp = np.tile(np.asarray(m.qpos0, np.float64), (B, 1))
        qp[:, :2] += 0.005 * rng.standard_normal((B, 2))
        for adr in (3, 7):  # the free joint's and the ball joint's quaternions
            q = qp[:, adr : adr + 4] + 0.1 * rng.standard_normal((B, 4))
            qp[:, adr : adr + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
        qp[:, 11] = -0.02 + 0.01 * rng.standard_normal(B)
        qv = 0.1 * rng.standard_normal((B, m.nv))
        ct = 0.5 * rng.standard_normal((T, m.nu, B))
    elif scene == "cylinder_push":
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
    import torch

    from judo_tpu_torch.tasks import get_registered_tasks

    if scene == "check":
        from judo_tpu_torch.models import check_scene

        return check_scene.load(np.float64 if dtype == torch.float64 else np.float32)

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


def k1_vs_plain(dtype_name: str, B: int = B_MAIN, scene: str = "leap", T: int = T_CHECK) -> dict:
    import torch

    from judo_tpu_torch.physics.fused_rollout import (fused_rollout, num_constraint_rows, rollout_lanes_reference,
                                                      rollout_warps, sm_count)

    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    m = scene_model(scene, dtype)
    qp, qv, ct = scene_inputs(scene, m, B, T + 1, seed=1, dtype=dtype, device="cuda")
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
    err["warps"] = rollout_warps(B, sm_count("cuda"), num_constraint_rows(m))  # the W fused_rollout picked
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


def full_horizon() -> dict:
    """Each kernel against its plain version on the card over its planning
    path's whole horizon, float64 then float32 on the same seeded inputs: K1 on leap
    (B_FULL rollouts, T_FULL steps, onset forces from one plain step), K2 on
    spot_navigate (R_SPOT rollouts, T_FULL policy ticks of 2 steps), K3
    chained T_FULL times at one environment as the plant steps (from
    leap_cube's reset with its reset command held, each tick from its own
    last state, a cold probe, zero forces, the model's own iterations), each
    chain against the plain version's chain. -> {"f64": {kernel: gap},
    "f32": {kernel: gap, kernel + "_plain_f32_vs_f64": the plain version's
    own float32 vs float64 gap}}, with each check's seconds (kernel +
    "_seconds"); each plain version runs once per dtype."""
    import torch

    from judo_tpu_torch.physics.fused_rollout import (
        fused_rollout, num_constraint_rows, physics_step, physics_step_reference, rollout_lanes_reference,
    )
    from judo_tpu_torch.physics.policy_rollout import fused_policy_rollout, policy_rollout_lanes_reference
    from judo_tpu_torch.tasks.leap_cube import LeapCube

    def gap(a, b) -> float:
        return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))

    res, plain64 = {"f64": {}, "f32": {}}, {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        e, t0 = res[name], time.perf_counter()

        def keep(kernel, ref, out):
            nonlocal t0
            e[f"{kernel}_seconds"], t0 = time.perf_counter() - t0, time.perf_counter()
            e[kernel] = gap(ref, out)
            if name == "f64":
                plain64[kernel] = ref
            else:
                e[f"{kernel}_plain_f32_vs_f64"] = gap(ref, plain64[kernel])

        m = scene_model("leap", dtype)
        qp, qv, ct = leap_inputs(m, B_FULL, T_FULL + 1, seed=12, dtype=dtype, device="cuda")
        zeros = torch.zeros((num_constraint_rows(m), B_FULL), dtype=dtype, device="cuda")
        f0 = rollout_lanes_reference(m, qp, qv, ct[:1], zeros, 1, 8)[3]
        ct = ct[1:].contiguous()
        keep("fused_rollout", rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8), fused_rollout(m, qp, qv, ct, f0, 1, 8))

        task = spot_task("spot_navigate", dtype)
        args = spot_inputs(task, R_SPOT, T_FULL, seed=13, dtype=dtype, device="cuda")
        keep("fused_policy_rollout", policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8),
             fused_policy_rollout(task.planning_model, task.policy, *args, 2, 8))

        plant = LeapCube(device="cuda", dtype=dtype, seed=0)
        col = lambda x: tensor(np.asarray(x)[:, None], dtype, "cuda")  # noqa: E731
        u, zeros = col(plant.reset_command), zeros[:, :1].contiguous()
        ref = out = (col(plant.qpos), col(plant.qvel))
        refs, outs = [], []
        for _ in range(T_FULL):
            ref = physics_step_reference(m, *ref[:2], u, zeros)
            out = physics_step(m, *out[:2], u, zeros)
            refs.append(torch.cat(ref))
            outs.append(torch.cat(out))
        keep("physics_step", [torch.stack(refs)], [torch.stack(outs)])
    torch.cuda.synchronize()
    return res


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


class EagerSolve:
    """The plain ``solve`` in place of a solve cache entry: the eager path the
    graph replaced, its state, time and metadata copied up from their pinned
    staging, its noise drawn from the carry's generator as an entry draws it."""

    def __call__(self, ctrl, carry, inputs):
        from judo_tpu_torch.controller.controller import solve
        from judo_tpu_torch.controller.solve_graph import draw_noise, tree_map

        inputs = tree_map(lambda x: x.to(ctrl.device, non_blocking=True), inputs)
        return solve(ctrl, carry, *inputs, draw_noise(ctrl, carry.generator))


def eager(c):
    """``c`` planning with the eager solve: its eager twin."""
    c._get_solve = lambda inputs: EagerSolve()
    return c


def graph_controller(task: str, opt: str, R: int | None, eager_twin: bool = False, mesh=None):
    """A float32 controller on the card, seeded (numpy's global state too, for
    the task's reset); the eager twin with ``eager_twin``; sharded over
    ``mesh``, on its lead device, with a mesh."""
    import torch

    from judo_tpu_torch.controller import make_controller

    np.random.seed(0)
    c = make_controller(task, opt, dtype=torch.float32, seed=0, mesh=mesh)
    if R:
        c.optimizer_cfg.num_rollouts = R
        c._sync_state_shapes()
    if task == "spot_navigate":
        c.task.config.goal_position = np.array([1.5, 0.5, 0.52])
    return eager(c) if eager_twin else c


def same_plan(a, b) -> bool:
    """Published times, knots, rewards and traces, and the carry, bitwise equal."""
    import torch

    from judo_tpu_torch.controller.solve_graph import CARRY_FIELDS, leaves

    tr = lambda c: np.zeros(0) if c.traces is None else c.traces  # noqa: E731
    pub = all(np.array_equal(x, y) for x, y in zip((a.times, a.nominal_knots, a.rewards, tr(a)),
                                                   (b.times, b.nominal_knots, b.rewards, tr(b))))
    ca, cb = ([x for f in CARRY_FIELDS for x in leaves(getattr(c._carry, f)) if x is not None] for c in (a, b))
    return pub and len(ca) == len(cb) and all(torch.equal(x, y) for x, y in zip(ca, cb))


def tune(c, task: str) -> None:
    """Temperature and sigma (those the optimizer has) by 1.25, a reward
    weight doubled, and the horizon one step shorter, inside its bucket."""
    for name in ("temperature", "sigma", "sigma_min", "sigma_max"):
        if hasattr(c.optimizer_cfg, name):
            setattr(c.optimizer_cfg, name, 1.25 * getattr(c.optimizer_cfg, name))
    *path, leaf = REWARD_WEIGHT[task]
    cfg = c.task.config
    for name in path:
        cfg = getattr(cfg, name)
    setattr(cfg, leaf, 2.0 * getattr(cfg, leaf))
    T = c.num_timesteps
    c.controller_cfg.horizon -= c.task.dt
    if c.num_timesteps != T:
        raise RuntimeError(f"{task}: the tuned horizon left its bucket ({T} -> {c.num_timesteps})")


def graph_phase(task: str, opt: str, R: int | None) -> dict:
    """The solve graph of ``task`` + ``opt`` against its eager twin: solves
    compared bitwise through a tune and a change of noise_ramp, the captures
    each made, the kernel's launches of the graph controller, then timed
    solves of both in turns."""
    import torch

    from judo_tpu_torch.controller.solve_graph import SolveGraph
    from judo_tpu_torch.physics.fused_rollout import fused_rollout
    from judo_tpu_torch.physics.policy_rollout import fused_policy_rollout

    g, e = graph_controller(task, opt, R), graph_controller(task, opt, R, eager_twin=True)
    kernel = fused_policy_rollout if g.task.uses_locomotion_policy else fused_rollout
    rng = np.random.default_rng(8)
    base = np.concatenate([g.task.qpos, np.zeros(g.pm.nv)])
    out = {"bitwise": [], "launches": 0, "solves": 0, "R": g.optimizer_cfg.num_rollouts, "T": g.num_timesteps}

    def both() -> None:
        s = base + np.r_[np.zeros(g.pm.nq), 0.02 * rng.standard_normal(g.pm.nv)]
        g.current_state, e.current_state = s.copy(), s.copy()
        before = kernel.launches
        g.update_action()
        out["launches"] += kernel.launches - before
        out["solves"] += 1
        e.update_action()
        torch.cuda.synchronize()
        out["bitwise"].append(same_plan(g, e))

    captures = SolveGraph.captures
    for n in range(GRAPH_SOLVES):
        if n == GRAPH_TUNE_AT:
            out["first_captures"], captures = SolveGraph.captures - captures, SolveGraph.captures
            for c in (g, e):
                tune(c, task)
        both()
    out["tune_captures"], captures = SolveGraph.captures - captures, SolveGraph.captures
    for c in (g, e):
        c.optimizer_cfg.noise_ramp *= 1.5
    for _ in range(GRAPH_AFTER_RAMP):
        both()
    out["ramp_captures"] = SolveGraph.captures - captures
    out["graph_ms"], out["eager_ms"] = [], []
    for _ in range(GRAPH_TIMED):
        s = base + np.r_[np.zeros(g.pm.nq), 0.02 * rng.standard_normal(g.pm.nv)]
        for c, key in ((g, "graph_ms"), (e, "eager_ms")):
            c.current_state = s.copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.update_action()
            torch.cuda.synchronize()
            out[key].append(1e3 * (time.perf_counter() - t0))
    return out


def switch_back() -> dict:
    """leap_cube -> cylinder_push -> leap_cube, each a new controller of a
    signature no earlier phase used: the entries made and graphs captured by
    the first two, and by the return (a cache hit: none)."""
    import torch

    from judo_tpu_torch.controller.solve_graph import SolveGraph

    counts = []
    for task, opt in (("leap_cube", "mppi"), ("cylinder_push", "ps"), ("leap_cube", "mppi")):
        before = (SolveGraph.builds, SolveGraph.captures)
        c = graph_controller(task, opt, SWITCH_R[task])
        c.current_state = np.concatenate([c.task.qpos, np.zeros(c.pm.nv)])
        c.update_action()
        torch.cuda.synchronize()
        counts.append((SolveGraph.builds - before[0], SolveGraph.captures - before[1]))
    return {"leap": counts[0], "cylinder_push": counts[1], "return": counts[2]}


def graph_pools() -> list | None:
    """(task, rollouts, steps, dtype, bytes) of each cached graph's private
    memory pool: its segments in the caching allocator's snapshot. None where
    the snapshot does not name segments' pools."""
    import torch

    from judo_tpu_torch.controller import Controller

    snap = torch.cuda.memory_snapshot()
    if snap and "segment_pool_id" not in snap[0]:
        return None
    out = []
    for sig, entry in list(Controller._solve_cache.items()):
        if not entry.graphs:
            continue
        d = dict(sig)
        out.append((d["task"][0].rsplit(".", 1)[-1], d["num_rollouts"], d["num_timesteps"], d["dtype"],
                    entry_pool_bytes(entry, snap)))
    return out


def entry_pool_bytes(entry, snap=None) -> int:
    """The bytes of a cache entry's graphs' private memory pools (a pool
    shared by several graphs counted once)."""
    import torch

    snap = torch.cuda.memory_snapshot() if snap is None else snap
    pools = {tuple(g.pool()) for g in entry.graphs}
    return sum(seg["total_size"] for seg in snap if tuple(seg["segment_pool_id"]) in pools)


def depth_path(task_name: str, R: int, warmup: int, timed: int, eager_twin: bool = False) -> dict:
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
    if eager_twin:
        eager(c)
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
        with gc_paused():
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


def plant_path(dtype_name: str) -> dict:
    """K3 as the plant: PLANT_TICKS ticks of JTSimulation on leap_cube, from
    its reset with the reset command held, each tick against the plain
    version on the card from the same state."""
    import torch

    from judo_tpu_torch.physics.fused_rollout import num_constraint_rows, physics_step_reference
    from judo_tpu_torch.simulation import JTSimulation
    from judo_tpu_torch.tasks.leap_cube import LeapCube

    dtype = torch.float64 if dtype_name == "f64" else torch.float32
    task = LeapCube(device="cuda", dtype=dtype, seed=0)
    sim = JTSimulation(task)
    m, ctrl = task.planning_model, task.reset_command
    f = torch.zeros((max(num_constraint_rows(m), 1), 1), dtype=dtype, device="cuda")
    col = lambda x: tensor(np.asarray(x)[:, None], dtype, "cuda")  # noqa: E731
    err, host_ms = 0.0, []
    reset_counts()
    for _ in range(PLANT_TICKS):
        ref = physics_step_reference(m, col(task.qpos), col(task.qvel), col(ctrl), f)
        ref_q, ref_v = (x[:, 0].double().cpu().numpy() for x in ref[:2])
        t0 = time.perf_counter()
        sim.step(ctrl)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        err = max(err, float(np.abs(task.qpos - ref_q).max()), float(np.abs(task.qvel - ref_v).max()))
    counts = read_counts()
    if counts["physics_step"] != PLANT_TICKS or not np.isfinite(np.r_[task.qpos, task.qvel]).all():
        raise RuntimeError(f"plant: launches {counts} in {PLANT_TICKS} ticks, finite state "
                           f"{bool(np.isfinite(np.r_[task.qpos, task.qvel]).all())}")
    return {"err": err, "counts": counts, "host_ms": host_ms}


def plant_beside_solve() -> dict:
    """One plant tick dispatched while a leap solve (320 rollouts, f32) is in
    flight: the controller at pipeline_depth 2 returns once its solve is
    queued on its stream; the tick then runs on the plant's own stream."""
    import torch

    from judo_tpu_torch.controller import make_controller
    from judo_tpu_torch.simulation import JTSimulation
    from judo_tpu_torch.tasks.leap_cube import QPOS_REST, LeapCube

    c = make_controller("leap_cube", "mppi", device="cuda", dtype=torch.float32, seed=0)
    c.optimizer_cfg.num_rollouts = B_MAIN
    c.controller_cfg.pipeline_depth = 2
    c.current_state = np.concatenate([QPOS_REST, np.zeros(c.pm.nv)])
    task = LeapCube(device="cuda", dtype=torch.float32, seed=0)
    sim = JTSimulation(task)
    c.update_action()
    c.flush_pipeline()
    sim.step(task.reset_command)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with gc_paused():
        start.record()
        c.update_action()
        end.record()
        t0 = time.perf_counter()
        sim.step(task.reset_command)
        tick_host_ms = 1e3 * (time.perf_counter() - t0)
        solve_ended_first = end.query()
    torch.cuda.synchronize()
    out = {"solve_ms": start.elapsed_time(end), "tick_done_ms": start.elapsed_time(sim.tick_done),
           "tick_host_ms": tick_host_ms, "solve_ended_first": solve_ended_first}
    c.flush_pipeline()
    return out


def closed_loop(task: str, optimizer: str, eager_twin: bool = False, extra: tuple = (),
                seconds: float = LOOP_SECONDS) -> dict:
    """``judo_tpu_torch.cli.main(["run", ..., *extra])`` with the judo_tpu
    plant for ``seconds``, its output captured and echoed; with
    ``eager_twin`` the controller node plans with the eager solve."""
    import contextlib
    import io

    from judo_tpu_torch import cli
    from judo_tpu_torch.app import nodes

    buf = io.StringIO()
    real = nodes.make_controller
    if eager_twin:
        nodes.make_controller = lambda *a, **k: eager(real(*a, **k))
    reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            rep = cli.main(["run", "--task", task, "--optimizer", optimizer, "--sim-backend", "judo_tpu", "--seconds",
                            str(seconds), *extra])
    finally:
        nodes.make_controller = real
    counts = read_counts()
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"  {line}")
    return {"report": rep, "counts": counts, "ended": bool(lines) and lines[-1] == "shutdown complete", "lines": lines}


def harness() -> str:
    """run_benchmark on leap_cube and cylinder_push with MPPI and PS, the
    judo_tpu plant, on the card; -> format_table."""
    from judo_tpu_torch.app.benchmark import format_table, run_benchmark

    results = run_benchmark(tasks=["leap_cube", "cylinder_push"], optimizers=["mppi", "ps"],
                            num_samples=HARNESS_SAMPLES, sim_backend="judo_tpu")
    for r in results:
        if r.times_s.shape != (HARNESS_SAMPLES,) or not np.all(np.isfinite(r.times_s)) or r.stages is None:
            raise RuntimeError(f"harness {r.task} {r.optimizer}: {r.times_s.shape} plan times, stages {r.stages}")
    return format_table(results)


def _websocket_module():
    """``judo_tpu_torch/visualizers/websocket.py`` loaded by its path, without
    the package (and so without torch): the GUI client's process stays light."""
    import importlib.util

    path = Path(__file__).resolve().parent / "judo_tpu_torch" / "visualizers" / "websocket.py"
    spec = importlib.util.spec_from_file_location("gui_websocket", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def gui_client(port: int, switch_at: float) -> int:
    """The GUI phase's browser: a process of its own that connects to the GUI
    server on ``port``, reads every message until the server closes, sets the
    MPPI temperature after 1 s, presses reset after 2 s and switches to
    cylinder_push after ``switch_at`` s; prints what it saw as one JSON line."""
    import socket

    ws = _websocket_module()
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.settimeout(60)
    conn = ws.client_handshake(sock, f"127.0.0.1:{port}")
    t0 = time.perf_counter()
    raw = conn.recv_message()
    hello = json.loads(raw)
    out = {"hello_task": hello["task"], "hello_bodies": len(hello["scene"]["bodies"]), "hello_bytes": len(raw.encode()),
           "states": [], "errors": [], "new_hello": None, "t_task": None}
    first = last = None
    sent = set()
    while True:
        try:
            raw = conn.recv_message()
        except (ConnectionError, OSError):
            break
        if raw is None:
            break
        t = time.perf_counter() - t0
        msg = json.loads(raw)
        if msg["type"] == "state":
            poses = np.asarray(msg["bodies"], np.float64)
            shape = None if msg["traces"] is None else list(np.asarray(msg["traces"]).shape)
            out["states"].append([t, poses.shape[0], bool(np.isfinite(poses).all()), shape, msg["num_elite"],
                                  msg["plan_time_ms"]])
            if poses.shape[0] == out["hello_bodies"] and out["t_task"] is None:  # leap's, before the switch
                first = poses if first is None else first
                last = poses
        elif msg["type"] == "hello":
            out["new_hello"] = {"t": t, "task": msg["task"], "bodies": len(msg["scene"]["bodies"])}
        elif msg["type"] == "error":
            out["errors"].append(msg["message"])
        for name, at, action in (("set", 1.0, {"type": "set", "group": "optimizer", "path": ["temperature"],
                                               "value": GUI_TEMPERATURE}),
                                 ("reset", 2.0, {"type": "reset"}),
                                 ("task", switch_at, {"type": "task", "name": "cylinder_push"})):
            if t >= at and name not in sent:
                conn.send_text(json.dumps(action))
                sent.add(name)
                out[f"t_{name}"] = t
    out["poses_moved"] = None if first is None else float(np.abs(last - first).max())
    print(json.dumps(out))
    return 0


def gui_loop() -> dict:
    """``cli.main(["run", ..., "--gui", ...])`` for leap_cube + mppi with the
    judo_tpu plant on a thread of this process, and ``gui_client`` in a
    process of its own; -> the loop's report, the launch counts of the run,
    the server's state-message times and what the client and the plant saw."""
    import contextlib
    import io
    import socket
    import threading

    from judo_tpu_torch import cli
    from judo_tpu_torch.app import nodes
    from judo_tpu_torch.visualizers import server as gui_server

    with socket.socket() as sock:
        sock.bind(("0.0.0.0", 0))
        port = sock.getsockname()[1]
    started, temperatures, resets = [], [], []

    class Recorded(gui_server.GuiServer):
        def start(self) -> None:
            self.bus.subscribe("optimizer_config", lambda cfg: temperatures.append(cfg.temperature))
            super().start()
            started.append(self)

    def recorded_reset(node, msg) -> None:
        resets.append(node.sim.task.name)
        real_reset(node, msg)

    real_server, real_reset = gui_server.GuiServer, nodes.SimulationNode._on_reset
    gui_server.GuiServer, nodes.SimulationNode._on_reset = Recorded, recorded_reset
    buf, result, client = io.StringIO(), {}, None

    def run() -> None:
        try:
            with contextlib.redirect_stdout(buf):
                result["report"] = cli.main(["run", "--task", "leap_cube", "--optimizer", "mppi", "--sim-backend",
                                             "judo_tpu", "--gui", "--gui-port", str(port), "--seconds",
                                             str(GUI_SECONDS)])
        except BaseException as e:  # noqa: BLE001 — handed to the main thread, which raises it
            result["error"] = e

    reset_counts()
    thread = threading.Thread(target=run)
    try:
        thread.start()
        deadline = time.time() + 600
        while not started and thread.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        if started:
            client = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--gui-client", str(port),
                                       str(GUI_SWITCH_AT)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        thread.join(timeout=GUI_SECONDS + 600)
    finally:
        gui_server.GuiServer, nodes.SimulationNode._on_reset = real_server, real_reset
        if client is not None:
            try:
                cout, cerr = client.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                client.kill()
                cout, cerr = client.communicate()
    counts = read_counts()
    if "error" in result:
        raise RuntimeError(f"GUI loop failed: {result['error']!r}") from result["error"]
    if thread.is_alive() or not started or client is None:
        raise RuntimeError(f"GUI loop: thread alive {thread.is_alive()}, server started {bool(started)}")
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"  {line}")
    if client.returncode != 0:
        raise RuntimeError(f"GUI client exited {client.returncode}: {cerr[-2000:]}")
    return {"report": result["report"], "counts": counts, "ended": bool(lines) and lines[-1] == "shutdown complete",
            "gui_line": f"GUI: http://localhost:{port}" in lines, "client": json.loads(cout.strip().splitlines()[-1]),
            "state_ms": 1e3 * np.asarray(started[0].state_times), "temperatures": temperatures, "resets": resets}


def _union_ms(intervals, lo: float, hi: float) -> float:
    """Length in ms of the union of (start, end) µs intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s_, e_ in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if cur_e is None or s_ > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    total += 0.0 if cur_e is None else cur_e - cur_s
    return total / 1e3


def profile_phase() -> dict:
    """``utils.profiling.trace`` around the PROFILE_SEGMENTS solves, each
    ``update_action`` in its own ``judo.plan`` span and each segment
    inside a ``span`` of its label (a depth-2 segment ends with
    ``flush_pipeline``, so its window holds its last solves). From the Chrome
    trace: K1's kernel events against its launch counter, and per segment the
    card's busy share, the union of its kernel and copy intervals over the
    segment's window."""
    import torch

    from judo_tpu_torch.controller import make_controller
    from judo_tpu_torch.tasks.leap_cube import QPOS_REST
    from judo_tpu_torch.utils.profiling import TRACE_PREFIX, span, trace

    controllers = []
    for label, task, opt, R, depth, calls, eager_twin in PROFILE_SEGMENTS:
        c = make_controller(task, opt, device="cuda", dtype=torch.float32, seed=0)
        c.optimizer_cfg.num_rollouts = R
        c.controller_cfg.pipeline_depth = depth
        if eager_twin:
            eager(c)
        rest = QPOS_REST if task == "leap_cube" else CYLINDER_PUSH_CONTACT
        c.current_state = np.concatenate([rest, np.zeros(c.pm.nv)])
        c.update_action()  # the first solve: kernels loaded, caches filled
        c.flush_pipeline()
        controllers.append(c)
    torch.cuda.synchronize()
    reset_counts()
    with trace(PROFILE_DIR) as prof:
        for (label, _, _, _, _, calls, _), c in zip(PROFILE_SEGMENTS, controllers):
            with span(label):
                for _ in range(calls):
                    c.update_action()
                c.flush_pipeline()
                torch.cuda.synchronize()
    counts = read_counts()
    events = [e for e in json.loads(prof.trace_path.read_text())["traceEvents"] if e.get("ph") == "X"]
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "fused_rollout_kernel" in e["name"]]
    regions = {e["name"].removeprefix(TRACE_PREFIX): e for e in events if e.get("cat") == "user_annotation"}
    segments = []
    for label, *_, calls, _ in PROFILE_SEGMENTS:
        r = regions[label]
        lo, hi = r["ts"], r["ts"] + r["dur"]
        busy = _union_ms(device, lo, hi)
        seg_k1 = [e for e in k1 if lo <= e["ts"] < hi]
        segments.append({"label": label, "calls": calls, "window_ms": (hi - lo) / 1e3, "busy_ms": busy,
                         "busy": busy / ((hi - lo) / 1e3), "k1_events": len(seg_k1),
                         "k1_ms": sum(e["dur"] for e in seg_k1) / 1e3,
                         "kernel_events": sum(1 for e in kernels if lo <= e["ts"] < hi),
                         "device_events": sum(1 for a, _ in device if lo <= a < hi)})
    n_regions = sum(1 for e in events if e.get("cat") == "user_annotation" and e["name"] == TRACE_PREFIX + "plan")
    return {"counts": counts, "k1_events": len(k1), "kernel_events": len(kernels), "segments": segments,
            "update_action_regions": n_regions, "trace": str(prof.trace_path)}


def mesh_devices() -> list:
    """Every visible card, or two shards on cuda:0 where only one is visible."""
    import torch

    n = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0", "cuda:0"]


def cross_device_bytes(c) -> int:
    """Bytes one solve of ``c`` moves between devices: each shard off the lead
    device gets its block of the controls, the start state and the carried
    warm start (or policy output) and sends back its states, sensors and
    carry, once per optimizer iteration; under a process group each process
    also receives the other rows' outputs."""
    import torch

    from judo_tpu_torch.controller.solve_graph import noise_shape
    from judo_tpu_torch.parallel.mesh import process_group, same_device

    pm, T = c.pm, c.num_timesteps
    nu_sim = c.task.task_to_sim_ctrl(torch.zeros((1, T, c.task.nu), dtype=c.dtype, device=c.device)).shape[-1]
    carry = 12 if c.task.uses_locomotion_policy else c._carry.efc_warm.shape[1]
    into = pm.nq + pm.nv + T * nu_sim + carry
    back = T * (pm.nq + pm.nv + pm.nsensordata) + carry
    off = sum(b for d, b in c.last_shards if not same_device(d, c.device))
    world, _ = process_group()
    local = sum(b for _, b in c.last_shards)
    per_iter = off * (into + back) + (world - 1) * local * back
    return noise_shape(c)[0] * per_iter * torch.finfo(c.dtype).bits // 8


def mesh_states(c, rng, n: int) -> list:
    """``n`` start states: the task's, with perturbed velocities."""
    base = np.concatenate([c.task.qpos, np.zeros(c.pm.nv)])
    return [base + np.r_[np.zeros(c.pm.nq), 0.02 * rng.standard_normal(c.pm.nv)] for _ in range(n)]


def timed_in_turns(pairs: list, states: list) -> dict:
    """Host ms of each (label, controller)'s update_action on each state, in
    turns, each call ended by a sync of every card."""
    import torch

    out = {label: [] for label, _ in pairs}
    for state in states:
        for label, c in pairs:
            c.current_state = state.copy()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.update_action()
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            out[label].append(1e3 * (time.perf_counter() - t0))
    return out


def mesh_pair(task: str, opt: str, R: int | None, mesh) -> dict:
    """A controller sharded over ``mesh`` beside its unsharded twin: solves
    compared bitwise through a tune, the kernel's launches of the sharded
    one, then timed solves of both in turns."""
    import torch

    from judo_tpu_torch.controller import Controller
    from judo_tpu_torch.physics.fused_rollout import fused_rollout, num_constraint_rows
    from judo_tpu_torch.physics.policy_rollout import fused_policy_rollout

    s, t = graph_controller(task, opt, R, mesh=mesh), graph_controller(task, opt, R)
    kernel = fused_policy_rollout if s.task.uses_locomotion_policy else fused_rollout
    rng = np.random.default_rng(12)
    out = {"bitwise": [], "launches": 0, "solves": 0, "R": s.optimizer_cfg.num_rollouts, "T": s.num_timesteps,
           "rows": num_constraint_rows(s.pm), "warps": set()}
    for n, state in enumerate(mesh_states(s, rng, MESH_SOLVES)):
        if n == MESH_TUNE_AT:
            for c in (s, t):
                tune(c, task)
        s.current_state, t.current_state = state.copy(), state.copy()
        before, by_warps = kernel.launches, dict(getattr(kernel, "launches_by_warps", {}))
        s.update_action()
        out["launches"] += kernel.launches - before
        out["warps"] |= {w for w, k in getattr(kernel, "launches_by_warps", {}).items() if k > by_warps.get(w, 0)}
        out["solves"] += 1
        t.update_action()
        torch.cuda.synchronize()
        out["bitwise"].append(same_plan(s, t))
    out.update(timed_in_turns([("sharded_ms", s), ("twin_ms", t)], mesh_states(s, rng, MESH_TIMED)))
    out["iterations"] = 1 if s.optimizer.stop_cond() else s.max_opt_iters
    out["shards"], out["bytes"] = s.last_shards, cross_device_bytes(s)
    entry = Controller._solve_cache[s._signature(s._solve_inputs()[1])]
    out["graphs"], out["pool_bytes"] = len(entry.graphs), entry_pool_bytes(entry)
    return out


def mesh_refused(mesh) -> str | None:
    """A leap controller of MESH_REFUSED_R rollouts on ``mesh``: the error
    its construction raises, or None if it does not."""
    import torch

    from judo_tpu_torch.controller import Controller, make_controller

    c = make_controller("leap_cube", "mppi", device="cuda", dtype=torch.float32, seed=0)
    c.optimizer_cfg.num_rollouts = MESH_REFUSED_R
    try:
        Controller(c.controller_cfg, c.task, c.optimizer, seed=0, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def mesh_waves(devices: list) -> dict:
    """leap_cube + mppi at MESH_WAVES_R rollouts (two waves of K1 on one
    card) unsharded on cuda:0 and sharded over two cards: bitwise, and timed
    in turns."""
    import torch

    from judo_tpu_torch.parallel import make_rollout_mesh

    one = graph_controller("leap_cube", "mppi", MESH_WAVES_R)
    two = graph_controller("leap_cube", "mppi", MESH_WAVES_R, mesh=make_rollout_mesh(devices=devices[:2]))
    rng = np.random.default_rng(13)
    same = []
    for state in mesh_states(one, rng, 2):
        for c in (one, two):
            c.current_state = state.copy()
            c.update_action()
        torch.cuda.synchronize()
        same.append(same_plan(one, two))
    out = timed_in_turns([("two_ms", two), ("one_ms", one)], mesh_states(one, rng, MESH_TIMED))
    out.update(bitwise=same, bytes=cross_device_bytes(two))
    return out


def mesh_rank(rank: int, world: int, port: int, path: str) -> int:
    """One process of the multi-process mesh: row ``rank`` of a (world, 1)
    hybrid mesh over cuda:0 .. cuda:world-1, NCCL; leap_cube + mppi at
    B_MAIN on the same start states as ``mesh_ranks``'s twin. Rank 0 writes
    each solve's rewards and knots, its plan times and launches to ``path``."""
    import torch

    from judo_tpu_torch.parallel import initialize_distributed, make_rollout_mesh
    from judo_tpu_torch.physics.fused_rollout import fused_rollout

    initialize_distributed(f"127.0.0.1:{port}", world, rank)
    mesh = make_rollout_mesh(devices=[f"cuda:{i}" for i in range(world)], hybrid=True, devices_per_host=1)
    torch.cuda.set_device(mesh.lead)
    c = graph_controller("leap_cube", "mppi", B_MAIN, mesh=mesh)
    rewards, knots, ms = [], [], []
    before = fused_rollout.launches
    for state in mesh_states(c, np.random.default_rng(14), MESH_RANK_SOLVES):
        c.current_state = state
        t0 = time.perf_counter()
        c.update_action()
        torch.cuda.synchronize(c.device)
        ms.append(1e3 * (time.perf_counter() - t0))
        rewards.append(c.rewards.copy())
        knots.append(np.asarray(c.nominal_knots).copy())
    if rank == 0:
        np.savez(path, rewards=np.asarray(rewards), knots=np.asarray(knots), ms=np.asarray(ms),
                 launches=fused_rollout.launches - before, shards=str(c.last_shards), bytes=cross_device_bytes(c))
    torch.distributed.destroy_process_group()
    return 0


def mesh_ranks() -> dict:
    """Two processes (``--mesh-rank``), each a row of the mesh on a card of
    its own, against an unsharded twin on cuda:0 in this process, bitwise."""
    import socket
    import tempfile

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=Path(__file__).resolve().parent / "chiprun_out") as tmp:
        path = str(Path(tmp) / "rank0.npz")
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(r), "2", str(port),
                                   path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        for proc in procs:
            try:
                logs.append(proc.communicate(timeout=600)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(proc.communicate()[0])
        if any(q.returncode != 0 for q in procs):
            raise RuntimeError(f"mesh ranks exited {[q.returncode for q in procs]}: {' | '.join(x[-1500:] for x in logs)}")
        with np.load(path) as z:
            got = {k: z[k] for k in z.files}
    twin = graph_controller("leap_cube", "mppi", B_MAIN)
    same, ms = [], []
    for k, state in enumerate(mesh_states(twin, np.random.default_rng(14), MESH_RANK_SOLVES)):
        twin.current_state = state
        t0 = time.perf_counter()
        twin.update_action()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        same.append(np.array_equal(twin.rewards, got["rewards"][k]) and np.array_equal(twin.nominal_knots,
                                                                                     got["knots"][k]))
    return {"bitwise": same, "ms": got["ms"], "twin_ms": ms, "launches": int(got["launches"]),
            "shards": str(got["shards"]), "bytes": int(got["bytes"])}


def mesh_phase(card: str, verdict) -> dict:
    """The rollouts split over a mesh of every visible card (two shards on
    cuda:0 where one is visible): each MESH_TASKS controller against its
    unsharded twin, the refused batch, and, with two or more cards, the
    two-wave batch over one card and two and the multi-process mesh. ->
    the sharded controllers' kernel launches."""
    import torch

    from judo_tpu_torch.parallel import make_rollout_mesh
    from judo_tpu_torch.physics.fused_rollout import rollout_warps, sm_count

    devices = mesh_devices()
    mesh = make_rollout_mesh(devices=devices)
    launches = {"fused_rollout": 0, "fused_policy_rollout": 0}
    ratios = {}
    for task_name, opt_name, R in MESH_TASKS:
        m = mesh_pair(task_name, opt_name, R, mesh)
        kernel = "fused_policy_rollout" if task_name.startswith("spot") else "fused_rollout"
        launches[kernel] += m["launches"]
        per_solve = len(m["shards"]) * m["iterations"]
        # K1's shards run at the warps per rollout of the whole batch
        rule = rollout_warps(m["R"], sm_count(devices[0]), m["rows"])
        warps = {rule} if kernel == "fused_rollout" else set()
        good = all(m["bitwise"]) and m["launches"] == per_solve * m["solves"] and m["warps"] == warps
        p50, twin50 = np.percentile(m["sharded_ms"], 50), np.percentile(m["twin_ms"], 50)
        ratios[task_name, m["R"]] = p50 / twin50
        label = (f"mesh {task_name} {opt_name} (bitwise {m['bitwise']}, launches {m['launches']} in {m['solves']} "
                 f"solves of {per_solve}, warps per rollout {sorted(m['warps'])} against {sorted(warps)})")
        print(f"mesh {task_name} {opt_name} R={m['R']} T={m['T']} f32 over {mesh.shape} {devices}: shards "
              f"{m['shards']} at warps per rollout {sorted(m['warps'])} (the whole batch's: {sorted(warps)}); "
              f"{m['solves']} solves bitwise equal to the unsharded twin in published times, knots, "
              f"rewards, traces and carry: {sum(m['bitwise'])} of {len(m['bitwise'])}; {kernel} launches "
              f"{m['launches']} ({m['launches'] / m['solves']:g} per solve, shards x iterations {per_solve}): "
              f"{verdict(label, good)}", flush=True)
        print(f"  time mesh {task_name}: sharded {pcts(m['sharded_ms'])}; twin {pcts(m['twin_ms'])}; p50 ratio "
              f"{ratios[task_name, m['R']]:.4f}; {MESH_TIMED} solves each in turns; {m['bytes']} bytes between devices per "
              f"solve; the entry's {m['graphs']} graph(s), pools {m['pool_bytes']} bytes on {card}", flush=True)
    if len(set(devices)) == 1:
        ratio = ratios["leap_cube", B_MAIN]
        print(f"mesh overlap: two leap shards on one card plan in {ratio:.4f}x the twin's p50 (limit "
              f"{MESH_OVERLAP_LIMIT}; one after the other they take about 1.85x): "
              f"{verdict(f'mesh overlap ({ratio:.4f}x)', ratio < MESH_OVERLAP_LIMIT)}", flush=True)
    refused = mesh_refused(make_rollout_mesh(devices=devices[:2]))
    print(f"mesh refusal: leap_cube R={MESH_REFUSED_R} on a 2-shard mesh raises ValueError: {refused!r}: "
          f"{verdict('mesh refusal (no ValueError)', refused is not None)}", flush=True)
    if torch.cuda.device_count() >= 2:
        w = mesh_waves(devices)
        label = f"mesh waves (bitwise {w['bitwise']})"
        print(f"mesh waves leap_cube mppi R={MESH_WAVES_R} f32: two cards {pcts(w['two_ms'])}, one card "
              f"{pcts(w['one_ms'])}, p50 ratio {np.percentile(w['two_ms'], 50) / np.percentile(w['one_ms'], 50):.4f}; "
              f"{w['bytes']} bytes between devices per solve; bitwise {w['bitwise']}: "
              f"{verdict(label, all(w['bitwise']))} on {card}", flush=True)
        r = mesh_ranks()
        label = f"mesh ranks (bitwise {r['bitwise']}, K1 launches {r['launches']} in {MESH_RANK_SOLVES} solves)"
        print(f"mesh ranks: 2 processes (NCCL), leap_cube mppi R={B_MAIN} on a (2, 1) hybrid mesh, rank 0's shards "
              f"{r['shards']}: {MESH_RANK_SOLVES} solves bitwise equal to the unsharded twin: {sum(r['bitwise'])} of "
              f"{len(r['bitwise'])}; rank 0 plan {pcts(r['ms'])} (twin {pcts(r['twin_ms'])}), K1 launches "
              f"{r['launches']}, {r['bytes']} bytes between devices per solve: "
              f"{verdict(label, all(r['bitwise']) and r['launches'] == MESH_RANK_SOLVES)} on {card}", flush=True)
    else:
        print(f"mesh waves and ranks: not run: {torch.cuda.device_count()} card visible; the two-wave batch over two "
              "cards and the two-process (NCCL) mesh need two or more", flush=True)
    loop = closed_loop("leap_cube", "mppi", extra=("--mesh", "hybrid"), seconds=MESH_LOOP_SECONDS)
    rep, counts, n = loop["report"], loop["counts"], torch.cuda.device_count()
    said = f"mesh: sharding {rep.rollouts} rollouts over {n} devices {{'hosts': 1, 'rollouts': {n}}}"
    # K1 once per shard for each plan and the warm-up; K3 once per tick
    good = (counts["physics_step"] == rep.ticks > 0 and counts["fused_rollout"] == n * (rep.plans + rep.warmup_plans)
            and rep.plans > 0 and rep.nonfinite_states == 0 and loop["ended"] and said in loop["lines"])
    label = (f"mesh loop (K3 {counts['physics_step']} for {rep.ticks} ticks, K1 {counts['fused_rollout']} for "
             f"{rep.plans} plans + {rep.warmup_plans} over {n} shards, non-finite states {rep.nonfinite_states}, "
             f"said {said!r}: {said in loop['lines']}, ended {loop['ended']})")
    print(f"mesh loop leap_cube + mppi R={rep.rollouts} --mesh hybrid (judo_tpu plant, {MESH_LOOP_SECONDS} s): "
          f"{rep.plans} plans ({pcts(rep.plan_ms)}), {rep.ticks} ticks of {rep.ticks_due} due "
          f"({100 * rep.ticks / max(rep.ticks_due, 1):.1f} %; pace limit {PACE_LIMIT:.0%}: "
          f"{'met' if rep.ticks >= PACE_LIMIT * rep.ticks_due else 'not met'}) ({pcts(rep.tick_ms)}), "
          f"{rep.overruns} overruns; physics_step launches {counts['physics_step']}, fused_rollout launches "
          f"{counts['fused_rollout']}; non-finite states {rep.nonfinite_states}; said {said!r}: "
          f"{verdict(label, good)} on {card}", flush=True)
    launches["fused_rollout"] += counts["fused_rollout"]
    launches["physics_step"] = counts["physics_step"]
    return launches


def mesh_only() -> int:
    """``--mesh``: the build and the mesh phase alone (every visible card)."""
    import torch

    card = card_info()
    print(f"card: {card}; {torch.cuda.device_count()} visible", flush=True)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this run needs a CUDA GPU", file=sys.stderr)
        return 1
    from judo_tpu_torch import _build
    from judo_tpu_torch.config import set_config_overrides
    from judo_tpu_torch.optimizers import MPPIConfig

    _build.load("cuda")
    set_config_overrides("leap_cube", MPPIConfig, {"num_rollouts": B_MAIN})
    failed = []

    def verdict(label: str, good: bool) -> str:
        if not good:
            failed.append(label)
        return "ok" if good else "FAIL"

    print(f"mesh launches {mesh_phase(card, verdict)}", flush=True)
    if failed:
        print(f"{len(failed)} checks failed (their lines are marked FAIL): {'; '.join(failed)}", file=sys.stderr)
        return 1
    return 0


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
        c.optimizer.draw_noise = lambda g, out, noise=noise: out.copy_(
            torch.as_tensor(noise, dtype=out.dtype, device=out.device))
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
        solver_iters,
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
    res[f"physics_step B={B_MAIN}"] = (k3, k3_plain, *bound_ms(io, B_MAIN * step_flops(m, 8, True)))
    # K3 at the plant's shape: one environment, the model's own solver iterations
    q1, v1, c1, f1 = (x[:, :1].contiguous() for x in (qp, qv, ct[0], f0))
    k3 = event_ms(lambda: physics_step(m, q1, v1, c1, f1), 200)
    k3_plain = event_ms(lambda: physics_step_reference(m, q1, v1, c1, f1), 3)
    io = 4 * (2 * (m.nq + m.nv + ne) + m.nu + m.nsensordata)
    res["physics_step"] = (k3, k3_plain, *bound_ms(io, step_flops(m, solver_iters(m, None), True)))

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
    # K1 at the shapes of the cylinder_push and fr3_pick paths; fr3's plain
    # version over its first FR3_PLAIN_STEPS steps, scaled to the horizon
    for scene, B, T, reps in (("cylinder_push", 32, 52, 20), ("fr3", 64, 252, 5)):
        m = scene_model(scene, f32)
        ne = num_constraint_rows(m)
        qp, qv, ct = scene_inputs(scene, m, B, T, seed=10, dtype=f32, device="cuda")
        f0 = torch.zeros((ne, B), dtype=f32, device="cuda")
        ms = event_ms(lambda: fused_rollout(m, qp, qv, ct, f0, 1, 8), reps)
        steps = FR3_PLAIN_STEPS if scene == "fr3" else T
        plain = T / steps * event_ms(lambda: rollout_lanes_reference(m, qp, qv, ct[:steps], f0, 1, 8), 1,
                                     warmup=False)
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
    per SM of each kernel at the paths' models, float32 and float64; the
    rollout kernel in blocks of one warp and of four (the rule's pick where
    the rollouts are few: fused_rollout.rollout_warps)."""
    import torch

    from judo_tpu_torch.physics.fused_rollout import kernel_layout

    lines = []
    for dtype in (torch.float32, torch.float64):
        name = "f32" if dtype == torch.float32 else "f64"
        leap, cyl, fr3 = (scene_model(s, dtype) for s in ("leap", "cylinder_push", "fr3"))
        rows = [("physics_step leap", leap, True, None, 1), ("physics_step fr3", fr3, True, None, 1)]
        for scene, m in (("leap", leap), ("cylinder_push", cyl), ("fr3", fr3), ("check", scene_model("check", dtype))):
            rows += [(f"fused_rollout {scene} W={w}", m, False, None, w) for w in (1, 4)]
        for scene in ("spot_navigate", *OBJECT_TASKS):
            task = spot_task(scene, dtype)
            rows.append((f"fused_policy_rollout {scene}", task.planning_model, False, task.policy, 1))
        for kernel, m, cold, policy, warps in rows:
            layout, nbytes, blocks = kernel_layout(m, dtype, cold, policy, warps)
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
    collections = full_collections()

    from judo_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load("cuda")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build_report(_build.build_log("cuda")):
        print(f"  {line}")
    for line in occupancy_report():
        print(f"  {line}", flush=True)

    errs, failed = {}, []

    def verdict(label: str, good: bool) -> str:
        """'ok' or 'FAIL'; a failed check's label is kept for the end of the run."""
        if not good:
            failed.append(label)
        return "ok" if good else "FAIL"

    def check(label: str, value: float, limit: float) -> None:
        good = verdict(f"{label} ({value:.3e})", value <= limit)
        print(f"{label}: max err {value:.3e} limit {limit:.0e} {good}", flush=True)

    def check_distance(label: str, name: str, e: dict) -> None:
        if "distance" not in e:
            return
        if name == "f64":
            check(f"{label} distance sensors", e["distance"], LIMITS["f64"])
        else:
            check(f"{label} distance sensors (the plain version's own f32 vs f64 error on them "
                  f"{e['distance_plain_f32_vs_f64']:.3e})", e["distance"], LIMITS["f32_distance"])

    for scene in ("leap", "cylinder_push", "fr3", "check"):
        T = K1_T.get(scene, T_CHECK)
        for name in ("f64", "f32"):
            for B in K1_B[scene]:
                e = errs[("fused_rollout", name, scene, B)] = k1_vs_plain(name, B, scene, T)
                lim = LIMITS[name]
                at = f"{scene} B={B} W={e['warps']}"  # the warps per rollout it ran
                for k in ("states", "sensors"):
                    check(f"fused_rollout vs plain {name} {at} T={T} {k}", e[k], lim)
                check_distance(f"fused_rollout vs plain {name} {at} T={T}", name, e)
                if name == "f64":
                    check(f"fused_rollout vs plain f64 {at} efc0", e["efc0"], lim)
                else:
                    check(f"fused_rollout vs plain f32 {at} efc0 relative (|efc0| max "
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

    t0 = time.perf_counter()
    horizon = full_horizon()
    shapes = {"fused_rollout": f"leap B={B_FULL} T={T_FULL}",
              "fused_policy_rollout": f"spot_navigate B={R_SPOT} T={T_FULL}x2",
              "physics_step": f"leap B=1 chained {T_FULL} ticks from the reset, the model's iterations"}
    for name in ("f64", "f32"):
        e = horizon[name]
        for kernel, shape in shapes.items():
            label = f"full horizon {kernel} vs plain {name} {shape}"
            if name == "f64":
                check(label, e[kernel], LIMITS["f64"])
            else:
                print(f"{label}: max err {e[kernel]:.3e}; the plain version's own f32 vs f64 gap "
                      f"{e[kernel + '_plain_f32_vs_f64']:.3e} (printed, not checked)", flush=True)
    seconds = ", ".join(f"{name} {k} {horizon[name][k + '_seconds']:.1f} s" for name in ("f64", "f32") for k in shapes)
    print(f"full horizon phase: {time.perf_counter() - t0:.1f} s ({seconds})", flush=True)

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
    d = depth_path("leap_cube", B_MAIN, 5, 20, eager_twin=True)
    print(f"pipelining leap_cube mppi R={B_MAIN} f32, eager twin (the plain solve, no graph), 5 + 20 calls: depth 0 "
          f"p50 {d[0]['p50_ms']:.2f} ms p95 {d[0]['p95_ms']:.2f} ms; depth 2 p50 {d[2]['p50_ms']:.2f} ms p95 "
          f"{d[2]['p95_ms']:.2f} ms, dispatch p50 {d[2]['dispatch_p50_ms']:.2f} ms on {card}", flush=True)
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
        label = (f"pipelining {task_name} (early {d2['early']} of {d2['calls']}, launches {d2['counts'][kernel]} and "
                 f"{d0['counts'][kernel]}, same {d['same']}, finite {d['finite']}, syncs {len(d['syncs'])})")
        print(f"pipelining {task_name}: every depth-2 call launched its kernel and returned before its solve ended, "
              f"the flushed mirrors are finite and equal depth 0's, and nothing on the dispatch path waited for the "
              f"card: {verdict(label, good)}", flush=True)
    plant = {}
    for name in ("f64", "f32"):
        p = plant[name] = plant_path(name)
        check(f"plant JTSimulation leap_cube {name}, {PLANT_TICKS} ticks, each vs the plain version on the card "
              f"from the same state", p["err"], LIMITS[name])
        print(f"plant {name}: physics_step launches {p['counts']['physics_step']} in {PLANT_TICKS} ticks; tick host "
              f"time {pcts(p['host_ms'])} (first tick {p['host_ms'][0]:.3f} ms) on {card}", flush=True)
    b = plant_beside_solve()
    good = not b["solve_ended_first"] and b["tick_done_ms"] < b["solve_ms"]
    label = (f"plant beside a leap solve (solve {b['solve_ms']:.3f} ms, tick {b['tick_done_ms']:.3f} ms, solve "
             f"ended first {b['solve_ended_first']})")
    print(f"plant beside a leap solve (R={B_MAIN}, depth 2): the solve ended {b['solve_ms']:.3f} ms after its "
          f"dispatch began, the plant tick's kernel {b['tick_done_ms']:.3f} ms after; the tick returned after "
          f"{b['tick_host_ms']:.3f} ms with the solve {'ended' if b['solve_ended_first'] else 'still running'}: "
          f"{verdict(label, good)} on {card}", flush=True)

    graphs = {}
    for task_name, opt_name, R in GRAPH_TASKS:
        gp = graphs[task_name] = graph_phase(task_name, opt_name, R)
        good = (all(gp["bitwise"]) and gp["tune_captures"] == 0 and gp["ramp_captures"] == 1
                and gp["launches"] == gp["solves"])
        label = (f"graph {task_name} {opt_name} (bitwise {gp['bitwise']}, captures {gp['tune_captures']} after the "
                 f"tune and {gp['ramp_captures']} after noise_ramp, launches {gp['launches']} in {gp['solves']} "
                 f"solves)")
        print(f"graph {task_name} {opt_name} R={gp['R']} T={gp['T']} f32: {gp['solves']} solves through the cache "
              f"bitwise equal to the eager solve in published times, knots, rewards, traces and carry: "
              f"{sum(gp['bitwise'])} of {len(gp['bitwise'])}; captures: {gp['first_captures']} in the first "
              f"{GRAPH_TUNE_AT} solves, {gp['tune_captures']} after the tune of temperature, sigma, a reward weight and "
              f"the horizon, {gp['ramp_captures']} after noise_ramp's change; kernel launches {gp['launches']} in "
              f"{gp['solves']} solves: {verdict(label, good)}", flush=True)
        print(f"  time graph {task_name} {opt_name}: graph {pcts(gp['graph_ms'])}; eager {pcts(gp['eager_ms'])}, "
              f"{GRAPH_TIMED} solves each in turns on {card}", flush=True)
    sb = switch_back()
    good = sb["leap"] == (1, 1) and sb["cylinder_push"] == (1, 1) and sb["return"] == (0, 0)
    print(f"graph switch leap_cube R={SWITCH_R['leap_cube']} -> cylinder_push R={SWITCH_R['cylinder_push']} -> "
          f"leap_cube, new controllers: (entries made, graphs captured) {sb['leap']}, {sb['cylinder_push']}, on the "
          f"return {sb['return']} (a cache hit): {verdict(f'graph switch and back {sb}', good)}", flush=True)
    pools = graph_pools()
    if pools is None:
        print("graph pools: not measured (the allocator's snapshot names no segment pools)", flush=True)
    for task_name, R, T, dt, nbytes in pools or ():
        print(f"graph pool {task_name} R={R} T={T} {dt}: {nbytes} bytes on {card}", flush=True)

    from judo_tpu_torch.config import set_config_overrides
    from judo_tpu_torch.optimizers import MPPIConfig

    # the main path's rollouts, as a launch config's optimizer_config_overrides set them
    set_config_overrides("leap_cube", MPPIConfig, {"num_rollouts": B_MAIN})
    loops = {}
    for task_name, opt_name in (("leap_cube", "mppi"), ("cylinder_push", "ps")):
        lp = loops[task_name] = closed_loop(task_name, opt_name)
        rep, counts = lp["report"], lp["counts"]
        # one rollout per plan (max_opt_iters 1) and one plan to warm up
        good = (counts["physics_step"] == rep.ticks > 0 and counts["fused_rollout"] == rep.plans + rep.warmup_plans
                and rep.plans > 0 and rep.nonfinite_states == 0 and lp["ended"])
        label = (f"closed loop {task_name} + {opt_name} (K3 {counts['physics_step']} for {rep.ticks} ticks, K1 "
                 f"{counts['fused_rollout']} for {rep.plans} plans, non-finite states {rep.nonfinite_states}, "
                 f"ended {lp['ended']})")
        print(f"closed loop {task_name} + {opt_name} R={rep.rollouts} (judo_tpu plant, {LOOP_SECONDS} s): "
              f"{rep.plans} plans ({pcts(rep.plan_ms)}), {rep.ticks} ticks of {rep.ticks_due} due "
              f"({100 * rep.ticks / max(rep.ticks_due, 1):.1f} %; pace limit {PACE_LIMIT:.0%}: "
              f"{'met' if rep.ticks >= PACE_LIMIT * rep.ticks_due else 'not met'}) ({pcts(rep.tick_ms)}), "
              f"{rep.overruns} overruns; physics_step launches {counts['physics_step']} (ticks {rep.ticks}), "
              f"fused_rollout launches {counts['fused_rollout']} (plans + {rep.warmup_plans} warm-up); non-finite states "
              f"{rep.nonfinite_states}; ends with 'shutdown complete': {lp['ended']}: "
              f"{verdict(label, good)} on {card}", flush=True)
    lp = closed_loop("leap_cube", "mppi", eager_twin=True)
    rep = lp["report"]
    print(f"closed loop leap_cube + mppi R={rep.rollouts}, eager twin (the plain solve, no graph; timed only): "
          f"{rep.plans} plans ({pcts(rep.plan_ms)}), {rep.ticks} ticks of {rep.ticks_due} due ({pcts(rep.tick_ms)}), "
          f"{rep.overruns} overruns on {card}", flush=True)
    print(f"harness: run_benchmark leap_cube and cylinder_push x mppi and ps, judo_tpu plant, cuda f32, "
          f"{HARNESS_SAMPLES} plans each, on {card}", flush=True)
    for line in harness().splitlines():
        print(f"  {line}", flush=True)

    gui = gui_loop()
    rep, counts, cl = gui["report"], gui["counts"], gui["client"]
    states, t_task = cl["states"], cl["t_task"] or float("inf")
    leap_states = [st for st in states if st[0] < t_task and st[1] == cl["hello_bodies"]]
    after = [st for st in states if cl["new_hello"] is not None and st[0] > cl["new_hello"]["t"]]
    span = leap_states[-1][0] - leap_states[0][0] if len(leap_states) > 1 else 0.0
    rate = (len(leap_states) - 1) / span if span > 0 else 0.0
    leap_traces = [st[3] for st in leap_states if st[3] is not None]
    plans_after = len({st[5] for st in after if st[1] == 4 and st[5] is not None})
    switch_ms = 1e3 * (cl["new_hello"]["t"] - t_task) if cl["new_hello"] is not None else float("nan")
    no_gui = loops["leap_cube"]["report"]
    # K3 once per tick; K1 once per plan, once to warm up and once for the switch's first solve
    checks = {
        "hello has leap_cube's 21 bodies": cl["hello_task"] == "leap_cube" and cl["hello_bodies"] == 21,
        f"state messages at >= {GUI_MIN_HZ:g} Hz": rate >= GUI_MIN_HZ,
        "every body pose finite": all(st[2] for st in states),
        "body poses moved": (cl["poses_moved"] or 0.0) > 1e-6,
        f"leap traces {LEAP_TRACES}": bool(leap_traces) and all(tr == LEAP_TRACES for tr in leap_traces),
        "every num_elite 0": all(st[4] == 0 for st in states),
        "temperature set and optimizer_config published": GUI_TEMPERATURE in gui["temperatures"],
        "task_reset reached the plant": "leap_cube" in gui["resets"],
        "new hello with cylinder_push's 4 bodies": cl["new_hello"] is not None and cl["new_hello"]["task"]
        == "cylinder_push" and cl["new_hello"]["bodies"] == 4,
        "plans after the switch": rep.task == "cylinder_push" and plans_after >= 5,
        "no error frame": not cl["errors"],
        "K3 launches = ticks": counts["physics_step"] == rep.ticks > 0,
        "K1 launches = plans + warm-up + switch": counts["fused_rollout"] == rep.plans + rep.warmup_plans + 1,
        "no non-finite state": rep.nonfinite_states == 0,
        "GUI address printed": gui["gui_line"],
        "ends with 'shutdown complete'": gui["ended"],
    }
    print(f"gui loop leap_cube + mppi R={B_MAIN} -> cylinder_push at {GUI_SWITCH_AT:g} s (judo_tpu plant, --gui, "
          f"{GUI_SECONDS} s): {rep.plans} plans ({pcts(rep.plan_ms)}); {rep.ticks} ticks of {rep.ticks_due} due "
          f"({100 * rep.ticks / max(rep.ticks_due, 1):.1f} %; pace limit {PACE_LIMIT:.0%}: "
          f"{'met' if rep.ticks >= PACE_LIMIT * rep.ticks_due else 'not met'}) ({pcts(rep.tick_ms)}), "
          f"{rep.overruns} overruns; {rate:.2f} leap states/s received ({len(leap_states)} before the switch, "
          f"{len(after)} after); state message build + encode {pcts(gui['state_ms'])} over {gui['state_ms'].size} "
          f"messages; hello {cl['hello_bytes']} B; task to new hello {switch_ms:.1f} ms; {plans_after} plans seen "
          f"after the switch; physics_step launches {counts['physics_step']} (ticks {rep.ticks}), fused_rollout "
          f"launches {counts['fused_rollout']} (plans {rep.plans} + 1 warm-up + 1 switch); the no-GUI leap loop's "
          f"plan p50 {np.percentile(no_gui.plan_ms, 50):.3f} ms in this run on {card}", flush=True)
    detail = (f"{rate:.2f} states/s, {plans_after} plans after the switch, K1 {counts['fused_rollout']} for "
              f"{rep.plans} plans, K3 {counts['physics_step']} for {rep.ticks} ticks, non-finite states "
              f"{rep.nonfinite_states}, task {rep.task}, resets {gui['resets']}, {len(cl['errors'])} error frames")
    for name, value in checks.items():
        print(f"  gui check {name}: {verdict(f'gui check {name} ({detail})', value)}", flush=True)
    for message in cl["errors"]:
        print(f"  gui error frame: {message}", flush=True)

    prof = profile_phase()
    good = (prof["kernel_events"] > 0 and prof["k1_events"] == prof["counts"]["fused_rollout"]
            == sum(seg["calls"] for seg in prof["segments"])
            and all(seg["k1_events"] == seg["calls"] for seg in prof["segments"])
            and prof["update_action_regions"] == sum(seg["calls"] for seg in prof["segments"]))
    label = (f"profile (K1 events {prof['k1_events']}, counter {prof['counts']['fused_rollout']}, per segment "
             f"{[(seg['k1_events'], seg['calls']) for seg in prof['segments']]}, update_action regions "
             f"{prof['update_action_regions']})")
    print(f"profile (torch.profiler, {prof['trace']}): {prof['kernel_events']} kernel events, K1 events "
          f"{prof['k1_events']} against the launch counter {prof['counts']['fused_rollout']}, "
          f"{prof['update_action_regions']} update_action regions: {verdict(label, good)} on {card}", flush=True)
    for seg in prof["segments"]:
        print(f"  profile {seg['label']}, {seg['calls']} calls: window {seg['window_ms']:.3f} ms, device busy "
              f"{seg['busy_ms']:.3f} ms, busy share {seg['busy']:.4f}, idle share {1 - seg['busy']:.4f}; K1 "
              f"{seg['k1_events']} events, {seg['k1_ms']:.3f} ms; {seg['kernel_events']} kernel events "
              f"({seg['kernel_events'] / seg['calls']:.1f} per solve), {seg['device_events']} kernel, copy and set "
              f"events ({seg['device_events'] / seg['calls']:.1f} per solve) on {card}", flush=True)

    mesh_launches = mesh_phase(card, verdict)

    for task_name, opt_name, R, horizon in (("leap_cube", "mppi", 16, 0.2), ("spot_navigate", "mppi", 4, 0.4),
                                            ("cylinder_push", "ps", 8, 0.2), ("fr3_pick", "cem", 4, 0.032),
                                            ("spot_box_push", "mppi", 4, 0.4)):
        d = solve_gpu_vs_cpu(task_name, opt_name, R, horizon)
        check(f"solve f64 {task_name} {opt_name} R={R} horizon {horizon} s cuda vs cpu (shared noise)", d,
              LIMITS["solve_f64"])

    t = timing()
    shapes = {"fused_rollout": f"leap B={B_MAIN} T={T_FULL}", "physics_step": "leap B=1 (the plant's shape)",
              "fused_policy_rollout": f"spot_navigate R={R_SPOT} T={T_FULL}x2"}
    for name, (ms, plain, bnd, by) in ((k, v) for k, v in t.items() if isinstance(v, tuple) and k[:3] != "k2 "):
        label = f"{name} {shapes[name]}" if name in shapes else name
        scaled = f" ({FR3_PLAIN_STEPS} steps timed, scaled to 252)" if "fr3" in name else ""
        print(f"time {label} f32: kernel {ms:.3f} ms, plain PyTorch {plain:.1f} ms{scaled}, bound {bnd:.4g} ms ({by}) "
              f"on {card}", flush=True)
    print(f"time fused_policy_rollout plain PyTorch per tick: {t['fused_policy_rollout'][1] / T_FULL:.1f} ms",
          flush=True)
    print(f"time fused_policy_rollout f32 with 0 physics substeps (observation, MLP, ctrl): "
          f"{t['k2_policy_only_ms']:.3f} ms on {card}", flush=True)
    for scene in OBJECT_TASKS:
        ms, tick, bnd, by = t[f"k2 {scene}"]
        print(f"time fused_policy_rollout {scene} R={R_SPOT} T={T_FULL}x2 f32: kernel {ms:.3f} ms, plain PyTorch "
              f"{tick:.1f} ms per tick, bound {bnd:.4f} ms ({by}) on {card}", flush=True)
    print(f"gc: {len(collections)} full collections, {max(collections, default=0.0):.1f} ms the longest, "
          f"{sum(collections):.1f} ms in all", flush=True)
    if failed:  # every phase ran; a check that failed above fails the run
        print(f"{len(failed)} checks failed (their lines are marked FAIL): {'; '.join(failed)}", file=sys.stderr)
        return 1

    launches = {"fused_rollout": leap["counts"]["fused_rollout"] + sum(p["counts"]["fused_rollout"]
                                                                       for p in new_paths.values()),
                "fused_policy_rollout": spot["counts"]["fused_policy_rollout"] + sum(
                    new_paths[s]["counts"]["fused_policy_rollout"] for s in OBJECT_TASKS),
                "physics_step": step["counts"]["physics_step"] + sum(p["counts"]["physics_step"]
                                                                      for p in (*plant.values(), *loops.values()))}
    launches["fused_rollout"] += sum(lp["counts"]["fused_rollout"] for lp in loops.values())
    launches["fused_rollout"] += gui["counts"]["fused_rollout"] + prof["counts"]["fused_rollout"]
    for gp in graphs.values():
        launches["fused_policy_rollout" if gp is graphs["spot_navigate"] else "fused_rollout"] += gp["launches"]
    launches["physics_step"] += gui["counts"]["physics_step"]
    for name, n in mesh_launches.items():
        launches[name] += n
    rows = [
        ("fused_rollout", "judo_tpu_torch/csrc/fused_rollout.cu", "judo_tpu/physics/pallas_step.py:162",
         max(e["states"] for k, e in errs.items() if k[0] == "fused_rollout" and k[1] == "f32")),
        ("fused_policy_rollout", "judo_tpu_torch/csrc/fused_policy_rollout.cu", "judo_tpu/physics/pallas_step.py:310",
         max(e["states"] for k, e in errs.items() if k[0] == "fused_policy_rollout" and k[1] == "f32"
             and k[2] != "flat tire")),
        ("physics_step", "judo_tpu_torch/csrc/fused_rollout.cu", "judo_tpu/physics/pallas_step.py:71",
         max(plant["f32"]["err"], *(errs[("physics_step", "f32", s)]["states"] for s in K3_B))),
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
    if sys.argv[1:2] == ["--gui-client"]:
        sys.exit(gui_client(int(sys.argv[2]), float(sys.argv[3])))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]))
    if sys.argv[1:2] == ["--mesh"]:
        sys.exit(mesh_only())
    sys.exit(main())
