"""Row 8 (``absmax_kernel`` + ``quant_kernel``): the bytes of every
quantized operand of a forward (bf16 in, s8 out, an fp32 scale a row;
shapes from the reference model at 2 x batch images) at the memory
rate, over the quantizer's device time per forward of the traced call."""
from benchmark import costs, trace


def read(run):
    t = run.trace
    if t is None or not run.facts["quant_bits"]:
        return None
    sites = [s for s in costs.forward_sites(
        run.config, 2 * run.facts["batch"], run.facts["quant_bits"],
        run.config["pallas_conv"]) if s.quantized]
    parts = [trace.per_call_ms(t.events, t.calls["forwards"], k)
             for k in ("absmax_kernel", "quant_kernel")]
    if not sites or not all(parts):
        return None
    return 100.0 * sum(costs.int8_quant_s(s) for s in sites) * 1e3 / sum(parts)
