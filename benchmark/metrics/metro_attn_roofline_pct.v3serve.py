"""metro_attn_roofline_pct.v3serve: the METRO stage's attention modules' least time
(their Q / K / V / O products and K3's 4 N^2 d a head, bf16, ``counts/metro.py``; N
from the program's ``metro_tokens`` counter) over their device time in the driver's
``bench.metro_attention`` hooks (%)."""
from benchmark.counts.metro import attention_widths, metro_attention_least_ms
from benchmark.program_spans import count_per_request


def read(out, cell):
    t = out.trace
    dev_s = t.span_device_s.get("metro_attention", 0.0) if t is not None else 0.0
    tokens = count_per_request(out, "metro_tokens")
    widths = attention_widths(out.facts.get("param_shapes", ()))
    if dev_s <= 0 or not tokens or not widths:
        return None
    B = cell.traffic["batch"]
    least_ms = metro_attention_least_ms(B, round(tokens / B), widths)
    return 100.0 * least_ms * t.steps / 1e3 / dev_s
