"""Row 9 (``int8_conv_wgmma_kernel`` + ``int8_conv_kernel``): 2 M N K
at the int8 peak against s8 bytes in and bf16 bytes out, summed over
the forward's quantized convs (shapes from the reference model at
2 x batch images), over both kernels' device time per forward of the
traced call."""
from benchmark import costs, trace


def read(run):
    t = run.trace
    if t is None or not run.facts["quant_bits"]:
        return None
    sites = [s for s in costs.forward_sites(
        run.config, 2 * run.facts["batch"], run.facts["quant_bits"],
        run.config["pallas_conv"]) if s.quantized]
    parts = [trace.per_call_ms(t.events, t.calls["forwards"], k)
             for k in ("int8_conv_wgmma_kernel", "int8_conv_kernel")]
    if not sites or not all(parts):
        return None
    return 100.0 * sum(costs.int8_conv_s(s) for s in sites) * 1e3 / sum(parts)
