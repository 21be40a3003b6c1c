"""Row 3 (``conv3x3_pair_kernel``): the bound of the forward's routed
3x3 64 -> 64 convs (their shapes from the reference model at 2 x batch
images) over their device time per forward of the traced call."""
from benchmark import costs, trace


def read(run):
    t = run.trace
    if t is None:
        return None
    sites = [s for s in costs.forward_sites(
        run.config, 2 * run.facts["batch"], run.facts["quant_bits"],
        run.config["pallas_conv"]) if s.row3]
    if not sites or run.config["pallas_conv"] not in ("on", "auto"):
        return None
    ms = trace.per_call_ms(t.events, t.calls["forwards"],
                           "conv3x3_pair_kernel")
    if not ms:
        return None
    return 100.0 * sum(costs.row3_s(s) for s in sites) * 1e3 / ms
