"""The share of the traced window's requests whose G forward was a replay
of a captured CUDA graph: ``gigagan.sample.graph_replay`` spans over
``gigagan.sample.request`` spans, in %.  None where the program does not
declare the replay span (it has no graph to replay) or the window holds
no request."""

from portbench.metrics._spans import UNIT, spans

REPLAY = "gigagan.sample.graph_replay"


def read(run):
    from gigagan_tpu_torch.utils import profiling

    found = spans(run, "sample")
    if found is None or REPLAY not in profiling.SPANS:
        return None
    requests = sum(n == UNIT["sample"] for _, _, n in found)
    return 100.0 * sum(n == REPLAY for _, _, n in found) / requests
