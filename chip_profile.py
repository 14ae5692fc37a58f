"""Profiling runs of the port's kernels on a CUDA GPU, beside chip_smoke.py.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_profile.py stages [W]  # per-stage split of K1 (leap, fr3_pick) and K2 (Spot)
    python3 chip_profile.py unroll   # the kernels against copies with loops unrolled or not
    python3 chip_profile.py horizon  # full-horizon kernel vs plain, and whole solve sequences
    python3 chip_profile.py inline   # the kernels against copies inlined otherwise
    python3 chip_profile.py compare DIR [W]  # the kernels against those of another checkout
    python3 chip_profile.py warps [8]  # K1 at 1 and 4 (and 8) warps per rollout
    python3 chip_profile.py bitwise DIR  # the kernels' outputs against another checkout's, bitwise
    python3 chip_profile.py layout   # the kernels against a copy that picks J's place at run time
    python3 chip_profile.py dispatch # where a pipelined planner's host waits

stages, unroll and inline copy judo_tpu_torch/csrc into
build/profile/<variant>/, patch the copy (the committed sources stay as they
are), build it with nvcc and run it at the paths' shapes in float32: leap
B 320, T 100; Spot R 24, T 100 policy ticks x 2 physics steps; fr3_pick B 64,
T 252.

- stages: thread 0 of each block reads clock64 between the stages of a
  physics step (after the block's barrier, __syncwarp in a block of one
  warp, so a stage ends when its slowest thread does) and around each policy
  tick, and adds the cycles to per-stage counters; the split is each stage's
  share of the summed cycles. K1 runs at W warps per rollout where W is
  given, else at the W the wrapper picks (fused_rollout.rollout_warps: leap's
  320 rollouts 1, fr3_pick's 64 4).
- unroll: times the checkout's kernels against two copies, one with the
  MLP's inner loop left rolled and one with the inner loops of the J passes
  (J^T x over rows, J y over dofs) unrolled by 8, in the order base, A, B, B,
  A, base within one process.
- inline: times the checkout's kernels (and K1 on fr3_pick, B 64, T 252),
  whose physics step is forced inline and whose narrowphase dispatch is a
  call, against a copy with the step left to the compiler (A), one with the
  dispatch inlined (B) and one with both (C), in the order base, A, B, C, C,
  B, A, base within one process, with each build's registers and stack.
- horizon: K1 (leap, B 64) and K2 (Spot, R 24) against their plain versions
  over the full T 100, float64 and float32; then chip_smoke.py's two solve
  sequences (warm-up and timed solves on the same perturbed states) in
  float64 and float32, printing the last solve's rewards. It uses only what
  chip_smoke.py has had since the Spot path was ported, so a copy of this
  file runs it in an older checkout too, for a comparison of two trees.
- layout: times the checkout's kernels, built once for each place of J
  (shared or global memory, a template parameter), against a copy whose
  step body picks J's place at run time from the sizes, in the order base,
  A, A, base within one process.
- dispatch: leap_cube + MPPI (320 rollouts, f32) at pipeline_depth 2, the
  dispatch and total host time of each of the first 25 calls; then how many
  small launches the host can queue behind a long kernel before a launch
  waits (torch.cuda._sleep holds the card).
- compare DIR [W]: K1 (leap B 320, T 100; fr3_pick B 64, T 252) and K2 (Spot
  R 24, T 100 x 2, and with no physics substeps) of the checkout DIR (an
  older one, unpacked with git archive) against this checkout's, each timed
  by its own chip_profile.py's main_shapes in a process of its own, in the
  order DIR, this, this, DIR; with W, this checkout's K1 at W warps per
  rollout (DIR's at its own). Both trees' kernels are built first, in
  parallel.
- bitwise DIR: the outputs of K1 (leap B 320, T 100; fr3_pick B 64, T 252),
  K2 (spot_navigate and the three object scenes, R 24, T 100 x 2) and K3
  (leap at B 1 with the model's own iterations, and at B 320 with 8),
  float32 and float64, made by the checkout DIR and by this one, each in a
  process of its own from its own chip_smoke.py's inputs, then compared with
  torch.equal; where they differ the largest difference is printed.
- warps [8]: K1 on leap (B 320, 64 and 32, T 100), fr3_pick (B 64 and 320,
  T 252), cylinder_push (B 32, T 52) and the check scene (B 64, T 50) at
  each W the wrapper builds (1, 4), in the order 1, 4, 4, 1 within one
  process; with 8, also at W = 8 (1, 4, 8, 8, 4, 1), from a copy that builds
  it. The sweep behind the rule that picks W (fused_rollout.rollout_warps).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

STAGES = ["smooth dynamics (lane 0)", "M inverse + qacc_smooth", "sensors (lane 0)", "narrowphase", "assembly",
          "solve prep (scaling + CW bound)", "APGD iterations", "J^T f + qacc", "implicit damping + qvel",
          "position update (lane 0)", "policy tick (obs + MLP + ctrl)", "distance sensors"]

CLOCK = '''#ifdef __CUDACC__
static __device__ unsigned long long jt_stage_cycles[16];
#endif
struct StageClock {
  long long t = 0;
  HD void sync() {
#ifdef __CUDA_ARCH__
    if (blockDim.x > 32) __syncthreads();
    else __syncwarp();
#endif
  }
  HD void start() {
#ifdef __CUDA_ARCH__
    sync();
    t = clock64();
#endif
  }
  HD void mark(int k) {
#ifdef __CUDA_ARCH__
    sync();
    const long long n = clock64();
    if (threadIdx.x == 0) atomicAdd(&jt_stage_cycles[k], (unsigned long long)(n - t));
    t = n;
#endif
  }
};
// Scalar helpers with one overload set'''

READ = '''
extern "C" int jt_stage_{name}(unsigned long long* out, int reset) {{
  if (reset) {{
    unsigned long long z[16] = {{0}};
    return (int)cudaMemcpyToSymbol(jt::jt_stage_cycles, z, sizeof(z));
  }}
  return (int)cudaMemcpyFromSymbol(out, jt::jt_stage_cycles, 16 * sizeof(unsigned long long));
}}
'''

# The files that build a kernel, and the tag of each one's stage reader; K1 at
# W = 4 is built in fused_rollout_w4.cu.
STAGE_FILES = {"fused_rollout.cu": "rollout", "fused_rollout_w4.cu": "rollout_w4", "fused_policy_rollout.cu": "policy"}

MLP_LOOP = "      for (int i = 0; i < ni; ++i) acc = acc + W[(int64_t)i * no + r] * w[in + i];"
MLP_PRAGMA = "#ifdef __CUDA_ARCH__\n#pragma unroll 8\n#endif\n"

# variant -> [(file, old, new)]; every old text must occur in the checkout
PATCHES = {
    "stages": [
        ("jt_common.cuh", "// Scalar helpers with one overload set", CLOCK),
        ("jt_step.cuh", "HD void dual_solve(const Ctx<T>& c) {\n",
         "HD void dual_solve(const Ctx<T>& c, StageClock& clk) {\n"),
        ("jt_step.cuh", "  const T step = T(1) / tmax(L, T(kMinval));\n",
         "  const T step = T(1) / tmax(L, T(kMinval));\n  clk.mark(5);\n"),
        ("jt_step.cuh", "  const T h = c.mf[0];\n  G::single([&] {\n    kinematics(c, qpos);\n",
         "  const T h = c.mf[0];\n  StageClock clk;\n  clk.start();\n  G::single([&] {\n    kinematics(c, qpos);\n"),
        ("jt_step.cuh", "    smooth_force(c, qpos, qvel, ctrl);\n  });\n",
         "    smooth_force(c, qpos, qvel, ctrl);\n  });\n  clk.mark(0);\n"),
        ("jt_step.cuh", "  island_mv<G>(c, c.S.Minv, c.S.qfrc, c.S.qacc_s, false);\n",
         "  island_mv<G>(c, c.S.Minv, c.S.qfrc, c.S.qacc_s, false);\n  clk.mark(1);\n"),
        ("jt_step.cuh", "  G::single([&] { sensors(c, qpos, qvel, sens_out); });\n",
         "  G::single([&] { sensors(c, qpos, qvel, sens_out); });\n  clk.mark(2);\n"),
        ("jt_step.cuh", "  distance_sensors<G>(c, sens_out);\n", "  distance_sensors<G>(c, sens_out);\n  clk.mark(11);\n"),
        ("jt_step.cuh", "    narrowphase<G>(c);\n    assemble<G>(c, qpos, qvel);\n    dual_solve<G>(c);\n",
         "    narrowphase<G>(c);\n    clk.mark(3);\n    assemble<G>(c, qpos, qvel);\n    clk.mark(4);\n"
         "    dual_solve<G>(c, clk);\n    clk.mark(6);\n"),
        ("jt_step.cuh", "  // implicit-in-velocity damping", "  clk.mark(7);\n  // implicit-in-velocity damping"),
        ("jt_step.cuh", "  G::single([&] { integrate_pos(c, qpos, qvel, h); });\n",
         "  clk.mark(8);\n  G::single([&] { integrate_pos(c, qpos, qvel, h); });\n  clk.mark(9);\n"),
        ("jt_policy.cuh", "    policy_tick(c, p, P, cmd_t);\n",
         "    StageClock clk;\n    clk.start();\n    policy_tick(c, p, P, cmd_t);\n    clk.mark(10);\n"),
    ],
    "mlp rolled": [("jt_policy.cuh", MLP_PRAGMA + MLP_LOOP, MLP_LOOP)],
    "step a call": [("jt_step.cuh", "HD_FORCEINLINE void step(", "HD void step(")],
    "pair dispatch inlined": [("jt_collision.cuh", "HD_NOINLINE void pair_contacts(", "HD void pair_contacts(")],
    "step a call, pair dispatch inlined": [("jt_step.cuh", "HD_FORCEINLINE void step(", "HD void step("),
                                           ("jt_collision.cuh", "HD_NOINLINE void pair_contacts(",
                                            "HD void pair_contacts(")],
    "J place at run time": [
        ("jt_step.cuh", "  c.J = JG ? jslab + (int64_t)b * c.S.jsize : work + c.S.J;",
         "  c.J = s.jglobal ? jslab + (int64_t)b * c.S.jsize : work + c.S.J;"),
    ],
    "warps 8": [
        ("fused_rollout.cu", "    case 4: return rollout_kernel_at<T, JG, 4>();\n",
         "    case 4: return rollout_kernel_at<T, JG, 4>();\n    case 8: return fused_rollout_kernel<T, JG, 8>;\n"),
    ],
    "J passes unrolled": [
        ("jt_step.cuh", "      for (int r = 0; r < ne; ++r) {\n        const T j = J[r * ld + v];",
         "#pragma unroll 8\n      for (int r = 0; r < ne; ++r) {\n        const T j = J[r * ld + v];"),
        ("jt_step.cuh", "    for (int v = 0; v < nv; ++v) {\n      const T j = J[r * ld + v];",
         "#pragma unroll 8\n    for (int v = 0; v < nv; ++v) {\n      const T j = J[r * ld + v];"),
    ],
}


def use_sources(variant: str | None) -> None:
    """Point the kernel build at the checkout's csrc (None) or at a patched
    copy of it, and drop the loaded library so that the next launch loads
    that build."""
    from judo_tpu_torch import _build

    csrc = ROOT / "judo_tpu_torch" / "csrc"
    if variant is None:
        _build.CSRC, _build.BUILD_DIR = csrc, ROOT / "build" / "judo_tpu_torch"
    else:
        dst = ROOT / "build" / "profile" / variant.replace(",", "").replace(" ", "_")
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(csrc, dst)
        for name, old, new in PATCHES[variant]:
            text = (dst / name).read_text()
            if old not in text:
                raise RuntimeError(f"patch {variant!r}: {old[:50]!r} not found in {name}")
            (dst / name).write_text(text.replace(old, new, 1))
        if variant == "stages":  # the counters are per file: one reader in each file that builds a kernel
            for name, tag in STAGE_FILES.items():
                (dst / name).write_text((dst / name).read_text() + READ.format(name=tag))
        _build.CSRC, _build.BUILD_DIR = dst, dst.parent / f"{dst.name}_build"
    _build._LOADED.clear()
    _build.load("cuda")


def main_shapes(warps: int | None = None):
    """Launchers of K1 (leap; fr3_pick where the checkout has it) at
    ``warps`` warps per rollout (None: the wrapper's pick) and K2 (Spot, and
    Spot with no physics substeps)."""
    import torch

    import chip_smoke as cs
    from judo_tpu_torch.physics import fused_rollout as fr
    from judo_tpu_torch.physics import policy_rollout as pr
    from judo_tpu_torch.tasks.leap_cube import LeapCube
    from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

    f32 = torch.float32
    m = LeapCube(device="cuda", dtype=f32).planning_model
    qp, qv, ct = cs.leap_inputs(m, cs.B_MAIN, cs.T_FULL, seed=4, dtype=f32, device="cuda")
    f0 = torch.zeros((fr.num_constraint_rows(m), cs.B_MAIN), dtype=f32, device="cuda")
    task = SpotNavigate(device="cuda", dtype=f32)
    args = cs.spot_inputs(task, cs.R_SPOT, cs.T_FULL, seed=9, dtype=f32, device="cuda")
    at = {} if warps is None else {"warps": warps}
    shapes = {
        "K1": lambda: fr.fused_rollout(m, qp, qv, ct, f0, 1, 8, **at),
        "K2": lambda: pr.fused_policy_rollout(task.planning_model, task.policy, *args, 2, 8),
        "K2 policy only": lambda: pr.fused_policy_rollout(task.planning_model, task.policy, *args, 0, 8),
    }
    if hasattr(cs, "scene_inputs"):  # K1 on fr3_pick, where the checkout has it
        m3 = cs.scene_model("fr3", f32)
        qp3, qv3, ct3 = cs.scene_inputs("fr3", m3, 64, 252, seed=10, dtype=f32, device="cuda")
        f3 = torch.zeros((fr.num_constraint_rows(m3), 64), dtype=f32, device="cuda")
        shapes["K1 fr3"] = lambda: fr.fused_rollout(m3, qp3, qv3, ct3, f3, 1, 8, **at)
    return shapes


def stages(card: str, warps: str | None = None) -> None:
    import torch

    import chip_smoke as cs
    from judo_tpu_torch import _build

    use_sources("stages")
    lib = _build.load("cuda")
    run = main_shapes(None if warps is None else int(warps))
    at = "the wrapper's W" if warps is None else f"W={warps}"
    buf = (ctypes.c_ulonglong * 16)()
    k1 = [tag for tag in STAGE_FILES.values() if tag != "policy"]
    for kernel, tags, shape in (("K1", k1, "leap B 320 T 100"), ("K2", ["policy"], "spot R 24 T 100 x 2"),
                                ("K1 fr3", k1, "fr3_pick B 64 T 252")):
        reads = [getattr(lib, f"jt_stage_{tag}") for tag in tags]
        run[kernel]()
        torch.cuda.synchronize()
        if any(read(buf, 1) != 0 for read in reads):
            raise RuntimeError("resetting the stage counters failed")
        run[kernel]()
        torch.cuda.synchronize()
        cycles = [0] * 16
        for read in reads:
            if read(buf, 0) != 0:
                raise RuntimeError("reading the stage counters failed")
            cycles = [a + b for a, b in zip(cycles, buf)]
        buf[:] = cycles
        total = sum(buf[: len(STAGES)])
        print(f"stage split {kernel} {shape} f32 (K1 at {at}; clock64 marks in a patched copy) on {card}:")
        for k, name in enumerate(STAGES):
            if buf[k]:
                print(f"  {name}: {100 * buf[k] / total:.1f} % ({buf[k]} cycles summed over thread 0 of all blocks)")
        print(f"  {kernel} with the marks: {cs.event_ms(run[kernel], 3):.3f} ms", flush=True)


def unroll(card: str) -> None:
    import chip_smoke as cs

    reps = {"K1": 10, "K2": 5, "K2 policy only": 5, "K1 fr3": 5}
    for variant in (None, "mlp rolled", "J passes unrolled", "J passes unrolled", "mlp rolled", None):
        use_sources(variant)
        run = main_shapes()
        times = ", ".join(f"{k} {cs.event_ms(fn, reps[k]):.3f} ms" for k, fn in run.items())
        print(f"unroll {variant or 'checkout'}: {times} f32 on {card}", flush=True)


def inline(card: str) -> None:
    import chip_smoke as cs

    reps = {"K1": 10, "K2": 5, "K2 policy only": 5, "K1 fr3": 5}
    both = "step a call, pair dispatch inlined"
    for variant in (None, "step a call", "pair dispatch inlined", both, both, "pair dispatch inlined", "step a call",
                    None):
        use_sources(variant)
        run = main_shapes()
        times = ", ".join(f"{k} {cs.event_ms(fn, reps[k]):.3f} ms" for k, fn in run.items())
        print(f"inline {variant or 'checkout'}: {times} f32 on {card}", flush=True)
        for line in cs.build_report(_build_log()):
            if "Used" in line or "entry function" in line:
                print(f"  {line}")


def _build_log() -> str:
    from judo_tpu_torch import _build

    return _build.build_log("cuda")


def layout(card: str) -> None:
    import chip_smoke as cs

    reps = {"K1": 10, "K2": 5, "K2 policy only": 5, "K1 fr3": 5}
    for variant in (None, "J place at run time", "J place at run time", None):
        use_sources(variant)
        run = main_shapes()
        times = ", ".join(f"{k} {cs.event_ms(fn, reps[k]):.3f} ms" for k, fn in run.items())
        print(f"layout {variant or 'checkout'}: {times} f32 on {card}", flush=True)


def dispatch(card: str) -> None:
    import time

    import torch

    from judo_tpu_torch.controller import make_controller

    c = make_controller("leap_cube", "mppi", device="cuda", dtype=torch.float32, seed=0)
    c.optimizer_cfg.num_rollouts = 320
    c.controller_cfg.pipeline_depth = 2
    for k in range(25):
        c.update_action()
        t = c.last_plan_timing
        print(f"dispatch leap depth 2 call {k}: dispatch {t['device_ms']:.2f} ms, total {t['total_ms']:.2f} ms, "
              f"in flight {len(c._pending) + len(c._consume_futures)} on {card}", flush=True)
    c.flush_pipeline()
    x = torch.zeros(16, device="cuda")
    for n in (64, 64, 128, 256, 512, 768, 1024, 2048):
        torch.cuda._sleep(int(4e8))
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        held = time.perf_counter() - t0
        torch.cuda.synchronize()
        print(f"dispatch queue: {n} launches behind a long kernel held the host {1e3 * held:.2f} ms on {card}",
              flush=True)


# Run in a checkout's root: time that checkout's kernels at main_shapes({args}).
TIME_TREE = """
import chip_profile as p, chip_smoke as cs
reps = {{"K1": 10, "K2": 5, "K2 policy only": 5, "K1 fr3": 5}}
print(", ".join(f"{{k}} {{cs.event_ms(fn, reps[k]):.3f}} ms" for k, fn in p.main_shapes({args}).items()), flush=True)
"""


# Run in a checkout's root: save that checkout's kernel outputs to argv[1].
OUTPUTS_TREE = """
import sys
import torch
import chip_smoke as cs
from judo_tpu_torch.physics import fused_rollout as fr, policy_rollout as pr
out = {}
for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
    for scene, B, T, seed in (("leap", 320, cs.T_FULL, 4), ("fr3", 64, 252, 10)):
        m = cs.scene_model(scene, dt)
        qp, qv, ct = cs.scene_inputs(scene, m, B, T, seed=seed, dtype=dt, device="cuda")
        f0 = torch.zeros((fr.num_constraint_rows(m), B), dtype=dt, device="cuda")
        out[f"K1 {scene} B {B} T {T} {name}"] = fr.fused_rollout(m, qp, qv, ct, f0, 1, 8)
    for scene in ("spot_navigate", *cs.OBJECT_TASKS):
        task = cs.spot_task(scene, dt)
        make = cs.spot_inputs if scene == "spot_navigate" else cs.object_inputs
        args = make(task, cs.R_SPOT, cs.T_FULL, seed=11, dtype=dt, device="cuda")
        out[f"K2 {scene} R {cs.R_SPOT} T {cs.T_FULL} x 2 {name}"] = pr.fused_policy_rollout(
            task.planning_model, task.policy, *args, 2, 8)
    m = cs.scene_model("leap", dt)
    for B, iterations in ((1, None), (320, 8)):
        qp, qv, ct = cs.scene_inputs("leap", m, B, 1, seed=6, dtype=dt, device="cuda")
        f = torch.zeros((fr.num_constraint_rows(m), B), dtype=dt, device="cuda")
        out[f"K3 leap B {B} {name}"] = fr.physics_step(m, qp, qv, ct[0], f, iterations)
torch.cuda.synchronize()
torch.save({k: [x.cpu() for x in v] for k, v in out.items()}, sys.argv[1])
"""


def _built(trees: dict) -> dict:
    """``trees`` (name -> checkout), each checkout's kernels built first, in parallel."""
    build = "from judo_tpu_torch import _build; _build.load('cuda')"
    procs = {k: subprocess.Popen([sys.executable, "-c", build], cwd=d) for k, d in trees.items()}
    for k, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"building the kernels of {trees[k]} failed")
    return trees


def bitwise(card: str, other: str) -> None:
    import torch

    trees = _built({"other": Path(other).resolve(), "this": ROOT})
    saved = {k: ROOT / "build" / f"bitwise_{k}.pt" for k in trees}
    for k, d in trees.items():
        out = subprocess.run([sys.executable, "-c", OUTPUTS_TREE, str(saved[k])], cwd=d, capture_output=True,
                             text=True)
        if out.returncode != 0:
            raise RuntimeError(f"the outputs of {d} failed: {out.stderr[-2000:]}")
    a, b = (torch.load(saved[k]) for k in ("other", "this"))
    for key in a:
        # bit for bit (a NaN of a diverged Spot rollout too, which == never equals)
        bits = {torch.float32: torch.int32, torch.float64: torch.int64}
        same = all(x.shape == y.shape and torch.equal(x.view(bits[x.dtype]), y.view(bits[y.dtype]))
                   for x, y in zip(a[key], b[key]))
        diff = max(float((x - y).nan_to_num(float("inf")).abs().max()) for x, y in zip(a[key], b[key]))
        print(f"bitwise {key}: {'equal' if same else f'differs, largest difference {diff:.3e}'} "
              f"({trees['other']} against this checkout) on {card}", flush=True)


def warps_sweep(card: str, eight: str | None = None) -> None:
    import torch

    import chip_smoke as cs
    from judo_tpu_torch.physics import fused_rollout as fr

    widths = list(fr.ROLLOUT_WARPS)
    if eight is not None:
        use_sources("warps 8")
        widths.append(8)
    f32 = torch.float32
    models = {s: cs.scene_model(s, f32) for s in ("leap", "fr3", "cylinder_push", "check")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs, picks = {}, []
    for scene, B, T, reps in (("leap", 320, cs.T_FULL, 10), ("leap", 64, cs.T_FULL, 10), ("leap", 32, cs.T_FULL, 10),
                              ("fr3", 64, 252, 5), ("fr3", 320, 252, 3), ("cylinder_push", 32, 52, 20),
                              ("check", 64, 50, 20)):
        m = models[scene]
        qp, qv, ct = cs.scene_inputs(scene, m, B, T, seed=10, dtype=f32, device="cuda")
        f0 = torch.zeros((fr.num_constraint_rows(m), B), dtype=f32, device="cuda")
        runs[f"K1 {scene} B {B} T {T}"] = (reps, lambda w, a=(m, qp, qv, ct, f0): fr.fused_rollout(*a, 1, 8, warps=w))
        rows = fr.num_constraint_rows(m)
        picks.append(f"{scene} B {B} ({rows} rows) W={fr.rollout_warps(B, sms, rows)}")
    print(f"warps: the rule picks {', '.join(picks)} on {card} ({sms} SMs)", flush=True)
    for w in widths + widths[::-1]:
        times = ", ".join(f"{k} {cs.event_ms(lambda fn=fn: fn(w), reps):.3f} ms" for k, (reps, fn) in runs.items())
        print(f"warps W={w}: {times} f32 on {card}", flush=True)


def compare(card: str, other: str, warps: str | None = None) -> None:
    trees = _built({"other": Path(other).resolve(), "this": ROOT})
    for k in ("other", "this", "this", "other"):
        args = "" if warps is None or k == "other" else str(int(warps))
        script = TIME_TREE.format(args=args)
        out = subprocess.run([sys.executable, "-c", script], cwd=trees[k], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"timing {trees[k]} failed: {out.stderr[-2000:]}")
        at = f" K1 at W={args}" if args else ""
        print(f"compare {k} ({trees[k]}){at}: {out.stdout.strip()} f32 on {card}", flush=True)


def horizon(card: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from judo_tpu_torch.controller import make_controller
    from judo_tpu_torch.physics import fused_rollout as fr
    from judo_tpu_torch.physics import policy_rollout as pr
    from judo_tpu_torch.tasks.leap_cube import QPOS_REST, LeapCube
    from judo_tpu_torch.tasks.spot.spot_navigate import SpotNavigate

    def report(label, ref, out, names):
        errs = " ".join(f"{n} {float((a - b).abs().max()):.3e}" for n, a, b in zip(names, ref, out) if n)
        drift = int(((ref[0] - out[0]).abs().amax(dim=(0, 1)) > 1e-2).sum())
        print(f"horizon {label}: {errs}; rollouts whose qpos drifts past 1e-2: {drift} on {card}", flush=True)

    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        task = SpotNavigate(device="cuda", dtype=dtype)
        args = cs.spot_inputs(task, cs.R_SPOT, cs.T_FULL, seed=9, dtype=dtype, device="cuda")
        ref = pr.policy_rollout_lanes_reference(task.planning_model, task.policy, *args, 2, 8)
        out = pr.fused_policy_rollout(task.planning_model, task.policy, *args, 2, 8)
        report(f"K2 vs plain {name} spot R={cs.R_SPOT} T={cs.T_FULL}", ref, out, ("qpos", "qvel", None, "pout"))
        m = LeapCube(device="cuda", dtype=dtype).planning_model
        qp, qv, ct = cs.leap_inputs(m, 64, cs.T_FULL, seed=4, dtype=dtype, device="cuda")
        f0 = torch.zeros((fr.num_constraint_rows(m), 64), dtype=dtype, device="cuda")
        ref = fr.rollout_lanes_reference(m, qp, qv, ct, f0, 1, 8)
        out = fr.fused_rollout(m, qp, qv, ct, f0, 1, 8)
        report(f"K1 vs plain {name} leap B=64 T={cs.T_FULL}", ref, out, ("qpos", "qvel"))
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        for task_name, R, warmup, timed, seed in (("spot_navigate", cs.R_SPOT, 1, 5, 3),
                                                  ("leap_cube", cs.B_MAIN, 3, 10, 2)):
            c = make_controller(task_name, "mppi", device="cuda", dtype=dtype, seed=0)
            c.optimizer_cfg.num_rollouts = R
            if task_name == "spot_navigate":
                c.task.config.goal_position = np.array([1.5, 0.5, 0.52])
                base = np.concatenate([c.task.qpos, np.zeros(c.pm.nv)])
            else:
                base = np.concatenate([QPOS_REST, np.zeros(c.pm.nv)])
            rng = np.random.default_rng(seed)

            def perturbed(c=c, base=base, rng=rng, leap=task_name == "leap_cube"):
                s = base.copy()
                if leap:
                    s[:3] += 5e-4 * rng.standard_normal(3)
                s[c.pm.nq :] += 0.02 * rng.standard_normal(c.pm.nv)
                return s

            cs.drive(c, warmup, timed, perturbed)
            r = np.sort(c.rewards)
            print(f"horizon solves {task_name} R={R} {name} ({warmup} + {timed}): last rewards min {r[0]:.6f} "
                  f"second {r[1]:.6f} median {float(np.median(r)):.6f} max {r[-1]:.6f} on {card}", flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs

    modes = {"stages": stages, "unroll": unroll, "inline": inline, "horizon": horizon, "compare": compare,
             "layout": layout, "dispatch": dispatch, "warps": warps_sweep, "bitwise": bitwise}
    # the arguments each mode takes, the least and the most
    nargs = {"stages": (0, 1), "compare": (1, 2), "bitwise": (1, 1), "warps": (0, 1)}
    args = sys.argv[2:]
    lo, hi = nargs.get(sys.argv[1], (0, 0)) if len(sys.argv) >= 2 else (0, 0)
    if len(sys.argv) < 2 or sys.argv[1] not in modes or not lo <= len(args) <= hi:
        print(f"usage: python3 chip_profile.py {{{'|'.join(modes)}}} (stages: [W]; compare: DIR [W]; bitwise: DIR; warps: [8])", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this run needs a CUDA GPU", file=sys.stderr)
        return 1
    modes[sys.argv[1]](cs.card_info(), *args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
