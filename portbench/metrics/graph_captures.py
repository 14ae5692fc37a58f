"""Solve graphs captured inside the window (``SolveGraph.captures`` of
``judo_tpu_torch/controller/solve_graph.py``): 0 when the warm-up captured
every shape the window plans; a capture in the window is a stall."""


def _captures() -> int:
    from judo_tpu_torch.controller.solve_graph import SolveGraph

    return SolveGraph.captures


def before_window(ctx) -> None:
    ctx.store["captures"] = _captures()


def after_window(ctx) -> None:
    ctx.store["captures"] = _captures() - ctx.store["captures"]


def read(ctx):
    return ctx.store.get("captures")
