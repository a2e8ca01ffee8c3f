"""The port's named spans (``repro_torch.tracing``) on reduced xlstm-350m
and zamba2-1.2b (4 layers, exits (1, 2); xlstm's layer 3 an sLSTM block,
zamba2's layers 1 and 3 its shared attention block), on the CPU: under
``timed`` the prefill and sLSTM spans add up their seconds, and under
``torch.profiler`` every span is a range named for its work."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.collm import CollmConfig  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ServingSystem  # noqa: E402
from repro_torch.tracing import PREFIX, timed  # noqa: E402


def serve(name):
    """A reduced model's two collm streams of 4 tokens, and the model."""
    cfg = dataclasses.replace(reduced(get_config(name), n_layers=4),
                              exit_layers=(1, 2)).validate()
    model = build_model(cfg, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (21, 30)]

    def run():
        return ServingSystem(model, CollmConfig(theta=0.5)
                             ).generate_sequential(prompts, 4)
    return run


def test_timed_sums_the_prefill_and_slstm_spans():
    run = serve("xlstm-350m")
    with timed("prefill", "slstm") as outer:
        with timed("slstm") as inner:
            run()
        run()
    assert 0.0 < inner["slstm"] < outer["slstm"] < outer["prefill"]
    assert set(outer) == {"prefill", "slstm"} and set(inner) == {"slstm"}


@pytest.mark.parametrize("name,works", [
    ("xlstm-350m", {"prefill", "slstm", "recurrent", "exit"}),
    ("zamba2-1.2b", {"prefill", "recurrent", "attention", "exit"})])
def test_spans_are_profiler_ranges(name, works):
    from torch.profiler import ProfilerActivity, profile
    run = serve(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    got = {e.name[len(PREFIX):] for e in prof.events()
           if e.name.startswith(PREFIX)}
    assert got == works
