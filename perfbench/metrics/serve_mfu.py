"""serve_mfu: useful FLOPs of every token stamped inside the window (a
first token: its prompt's prefill; a later one: its decode step) over the
window's seconds x the bf16 peak, in %."""
from perfbench.harness import yardstick


def read(rec):
    v, model = rec["view"], rec["model"]
    t0, t1 = v["t_start"], v["t_end"]
    flops = 0.0
    for tr in v["tracks"]:
        plen = tr.req.prompt_len
        for j, t in enumerate(tr.times):
            if t0 < t <= t1:
                flops += model.prompt_flops(plen) if j == 0 else model.decode_flops(plen + j - 1)
    return 100.0 * flops / (v["window_s"] * yardstick.PEAK_BF16_FLOPS) if flops else None
