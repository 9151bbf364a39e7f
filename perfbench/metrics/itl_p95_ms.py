"""itl_p95_ms: 95th percentile of every gap between two consecutive output
tokens of one request, over all gaps inside the window."""
from perfbench.harness import stats


def read(rec):
    p = stats.percentile(stats.token_gaps(rec["view"]), 95)
    return None if p is None else 1e3 * p
