"""What the readers of the program's own spans and counters share.  They
read ``stable_nerf_tpu_torch.utils.profiling``'s records, imported inside
the call: spans record only while a profiler runs, so the records are the
traced block's.  A program without the records (an older commit) gives
None, as does a span table without device times (a run on the CPU)."""


def _profiling():
    try:
        from stable_nerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "span_records") else None


def _spans(run, names, root):
    """The records called one of ``names`` in units whose root span is
    ``root``; None where there is none, or one has no device time."""
    prof = _profiling()
    if run["trace"] is None or not run["trace"]["units"] or prof is None:
        return None
    recs = prof.span_records()
    roots = {r["id"] for r in recs if r["name"] == root and r["parent"] is None}
    got = [r for r in recs if r["name"] in names and r["unit"] in roots]
    if not got or any(r["device_ms"] is None for r in got):
        return None
    return got


def per_unit_ms(run, names, root, clock="device_ms"):
    """The spans' summed ms on ``clock`` ("device_ms" or "host_ms") over
    the traced block's units."""
    got = _spans(run, names, root)
    return None if got is None else sum(r[clock] for r in got) / run["trace"]["units"]


def mean_ms(run, name, root, clock="device_ms"):
    """The spans' mean ms on ``clock``."""
    got = _spans(run, (name,), root)
    return None if got is None else sum(r[clock] for r in got) / len(got)


def counter_share(run, part, whole):
    """100 · counter ``part`` / counter ``whole`` over the traced block, %."""
    prof = _profiling()
    if run["trace"] is None or prof is None:
        return None
    c = prof.counters()
    if not c.get(whole) or part not in c:
        return None
    return 100.0 * c[part] / c[whole]
