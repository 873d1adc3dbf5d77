"""model_host_s: seconds per request in the model's host phases that do
no device work (the configuration's ``phases.model_host_s`` list)."""

from benchmark.metrics import _phases


def read(run):
    return _phases.per_request(run, "model_host_s")
