"""What several metric readers share.  A reader takes the run's record
(``benchmark/harness/cli.py::run``) and returns a number, or None where
the run has nothing for it to read."""

import statistics

K1_KERNELS = ("corner8_f2_kernel", "flat_shared_f2_kernel", "flat_f2_kernel", "flat_kernel")
# the hash encode's forward and backward (stable_nerf_tpu_torch/csrc/hash_encode.cu)
ENCODE_KERNELS = ("hash_encode_fwd_kernel", "hash_encode_bwd_kernel")


def peaks(run):
    from benchmark.harness import flops

    return (flops.PEAK_BF16_FLOPS.get(run["kind_name"]),
            flops.PEAK_HBM_BYTES.get(run["kind_name"]))


def mfu(run, unit):
    """The work's FLOPs over the window's time and the dense bf16 peak, %."""
    peak, _ = peaks(run)
    if run["unit"] != unit or not run["units"] or peak is None:
        return None
    return 100.0 * run["flops_per_unit"] * run["units"] / run["window_s"] / peak


def device_idle(run):
    """Share of the traced window in which no kernel, copy or fill ran, %."""
    t = run["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def scatter_roofline(run):
    """K1's least time (its bytes over the HBM peak) over its summed
    kernel time in the trace, %."""
    t = run["trace"]
    launches_unit, bytes_unit = run["scatter_per_unit"]
    _, bw = peaks(run)
    if t is None or not launches_unit or bw is None:
        return None
    rows = [r for r in t["kernels"] if any(k in r[0] for k in K1_KERNELS)]
    launches = sum(r[2] for r in rows)
    ms = sum(r[1] for r in rows)
    if not launches or ms <= 0:
        return None
    return 100.0 * launches * (bytes_unit / launches_unit) / bw / (ms / 1e3)


def mean_ms(values):
    return 1e3 * statistics.fmean(values) if values else None


def rays_per_s(run):
    """Rays trained in the window over its seconds."""
    if run["unit"] != "steps" or "rays" not in run["traffic"] or not run["units"]:
        return None
    return run["traffic"]["rays"] * run["units"] / run["window_s"]
