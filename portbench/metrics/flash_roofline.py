"""``flash_roofline``: the prefill calls' attention against the card's
roofline, in %.

For each prefill call in the traced part, each layer's causal attention
over the requests' own prompts (the rows that pad the batch and the left
padding of each prompt to its bucket are not counted): 4 H hd operations
for each (query, key) pair of the causal triangle, in bfloat16 (989
TFLOP/s), and q, k, v in and o out, each byte once (3.35 TB/s); its least
time is the larger of the two. The device time is that of the kernels
named ``flash`` in the trace."""
from portbench.harness import flops
from portbench.harness.peaks import bound_seconds

BF16 = 2


def call_bound_seconds(config: dict, lengths) -> float:
    c = flops.lm_dims(config)
    per_layer_ops = flops.prefill_attention_flops(config, lengths) / c["L"]
    per_layer_bytes = (sum(lengths) * (2 * c["H"] + 2 * c["KVH"]) * c["hd"]
                       * BF16)
    return c["L"] * bound_seconds(per_layer_ops, per_layer_bytes, "bfloat16")


def read(ctx):
    trace, win = ctx["trace"], ctx["win"]
    if trace is None:
        return None
    kernel_s = trace.seconds_of(lambda name: "flash" in name)
    bound = sum(call_bound_seconds(ctx["config"], c[6]) for c in ctx["calls"]
                if c[0] == "prefill" and win.in_traced_part(c[1]))
    if kernel_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / kernel_s
