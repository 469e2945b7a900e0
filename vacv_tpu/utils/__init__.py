from .compare import MAX_DIFF, REF_MAX_DIFF, cosine_similarity, passes
from .perf import Timer, count_traces, time_fn, time_perf
