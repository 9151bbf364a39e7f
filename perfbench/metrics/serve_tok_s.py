"""serve_tok_s: output tokens stamped inside the window over its seconds
(every request's, those still in flight at the end too)."""
from perfbench.harness import stats


def read(rec):
    v = rec["view"]
    return stats.tokens_in(v) / v["window_s"]
