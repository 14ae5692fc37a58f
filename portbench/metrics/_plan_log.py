"""The controller's records of the solves the window dispatched: the
window's first and last solve ids from the controller's
``solves_dispatched`` before and after it, and its ``plan_log`` records of
the ids between (each ``{"id", "spans": name -> ms, "latency_ms"}``). A
program without them (no ``plan_log``) gives no records, and the readers
read nothing."""


def before_window(ctx) -> None:
    ctx.store["first_solve"] = getattr(ctx.program, "solves_dispatched", None)


def after_window(ctx) -> None:
    """After the window's flush: every solve it dispatched is published."""
    first, log = ctx.store.get("first_solve"), getattr(ctx.program, "plan_log", None)
    if first is None or log is None:
        ctx.store["solves"] = []
        return
    last = ctx.program.solves_dispatched
    ctx.store["solves"] = [r for r in log if first <= r["id"] < last]


def span_ms(ctx, name: str) -> list[float]:
    """The window's solves' ``name`` span, in ms."""
    return [r["spans"][name] for r in ctx.store.get("solves", []) if name in r["spans"]]


def latency_ms(ctx) -> list[float]:
    return [r["latency_ms"] for r in ctx.store.get("solves", [])]
