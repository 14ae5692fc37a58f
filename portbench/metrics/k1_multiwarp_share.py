"""The share, in %, of the window's K1 launches that ran more than one warp
per rollout (``fused_rollout.launches_by_warps`` of
``judo_tpu_torch/physics/fused_rollout.py``: each launch counted at its W,
a solve graph's replay adding the W of the launches it captured). 100 where
the rollouts are too few to give each SM's schedulers a warp, 0 where they
fill the card; None where the program keeps no such count or launched no K1
in the window."""


def _by_warps() -> dict | None:
    from judo_tpu_torch.physics import fused_rollout as fr

    by_warps = getattr(fr.fused_rollout, "launches_by_warps", None)
    return None if by_warps is None else dict(by_warps)


def before_window(ctx) -> None:
    ctx.store["k1_by_warps"] = _by_warps()


def after_window(ctx) -> None:
    before, after = ctx.store.get("k1_by_warps"), _by_warps()
    if before is None or after is None:
        ctx.store["k1_by_warps"] = None
        return
    ctx.store["k1_by_warps"] = {w: n - before.get(w, 0) for w, n in after.items() if n > before.get(w, 0)}


def read(ctx):
    window = ctx.store.get("k1_by_warps")
    total = sum(window.values()) if window else 0
    if not total:
        return None
    return 100.0 * sum(n for w, n in window.items() if w > 1) / total
