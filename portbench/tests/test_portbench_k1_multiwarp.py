"""The arithmetic of ``k1_multiwarp_share`` on stubbed launch counts: the
share of the window's K1 launches that ran more than one warp per rollout."""

from __future__ import annotations

from types import SimpleNamespace

from portbench import cells


def test_k1_multiwarp_share_reads_the_window_by_width(monkeypatch):
    """100 where every window launch ran more than one warp per rollout, 0
    where none did, a share between, and None where the program keeps no
    count by width (an older program) or launched no K1 in the window."""
    from judo_tpu_torch.physics import fused_rollout as fr

    reader = cells.metric_reader("k1_multiwarp_share")

    def window(before: dict | None, after: dict | None):
        ctx = SimpleNamespace(store={})
        if before is None:
            monkeypatch.delattr(fr.fused_rollout, "launches_by_warps", raising=False)
        else:
            monkeypatch.setattr(fr.fused_rollout, "launches_by_warps", dict(before), raising=False)
        reader.before_window(ctx)
        if after is not None:
            monkeypatch.setattr(fr.fused_rollout, "launches_by_warps", dict(after), raising=False)
        reader.after_window(ctx)
        return reader.read(ctx)

    assert window({1: 5}, {1: 5, 4: 30}) == 100.0
    assert window({1: 5, 4: 2}, {1: 35, 4: 2}) == 0.0
    assert window({}, {1: 3, 2: 1}) == 25.0
    assert window({4: 7}, {4: 7}) is None
    assert window(None, None) is None
