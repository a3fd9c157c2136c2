"""Device ms of the hash encode a fit step, over the traced block's steps:
the rows of the encode's forward and backward kernels (``ENCODE_KERNELS``)
in the block's device trace, the forward encodes of its one occupancy
refresh included.  A fit step replayed from its CUDA graph runs no Python
inside, so the encode's spans do not fire there.  A program whose encode
runs no such kernel (the plain encode, eager) is read from its spans
instead: nerf.hash_encode and nerf.hash_encode_backward inside fit.step."""
from benchmark.metrics._shared import ENCODE_KERNELS
from benchmark.metrics._spans import per_unit_ms


def read(run):
    t = run["trace"]
    if t is None or not t["units"]:
        return None
    rows = [r for r in t.get("kernels", ()) if any(k in r[0] for k in ENCODE_KERNELS)]
    if rows:
        return sum(r[1] for r in rows) / t["units"]
    return per_unit_ms(run, ("nerf.hash_encode", "nerf.hash_encode_backward"), "fit.step")
