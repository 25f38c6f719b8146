"""Blocking device-to-host reads per draw step of the cell's job over the
whole process: the counters `host_reads` / `steps` that
l2hmc_torch.utils.spans keeps per job (a history update's grab of each
tensor, the loops' mean reads, a synchronisation). None where the program
has no such counters."""


def read(ctx):
    if ctx["kind"] != "draw" or ctx["trace"]["window_s"] <= 0:
        return None
    try:
        from l2hmc_torch.utils import spans
    except ImportError:
        return None
    counts = spans.summary()["counters"].get(ctx["job"], {})
    if not counts.get("steps") or "host_reads" not in counts:
        return None
    return counts["host_reads"] / counts["steps"]
