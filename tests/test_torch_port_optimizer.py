"""The port's TPE optimizer against the JAX package's.

Both samplers draw from ``random.Random(seed)`` and
``np.random.default_rng(seed)`` in one order, so one seed and one
objective must give identical suggestions (compared with ``==``, no
tolerance) for 30 trials, past the 10 random startup trials into the
Parzen estimator, over uniform, log-uniform, integer and categorical
parameters, with and without a warm start. The JSONL journal is one
format: each package resumes the other's and then suggests what the
writer would have.
"""

import json

import pytest

from pyannote_audio_tpu.core import optimizer as jax_optimizer
from pyannote_audio_tpu.core import parameter as jax_parameter
from pyannote_audio_tpu_torch.core import optimizer, parameter
from test_torch_port_models import one_torch_thread  # noqa: F401

TRIALS = 30


def space(p):
    return {
        "segmentation": p.ParamDict(min_duration_off=p.Uniform(0.0, 1.0)),
        "clustering": p.ParamDict(threshold=p.Uniform(0.0, 2.0),
                                  method=p.Categorical(["a", "b", "c"]),
                                  min_cluster_size=p.Integer(1, 20),
                                  Fa=p.LogUniform(1e-3, 1.0),
                                  frozen=p.Frozen(3))}


WARM = {"segmentation": {"min_duration_off": 0.5},
        "clustering": {"threshold": 1.5, "method": "a",
                       "min_cluster_size": 15, "Fa": 0.07}}


def objective(params):
    flat = optimizer.flatten_params(params)
    return ((flat["segmentation.min_duration_off"] - 0.3) ** 2
            + (flat["clustering.threshold"] - 0.7) ** 2
            + abs(flat["clustering.min_cluster_size"] - 7) / 20
            + abs(flat["clustering.Fa"] - 0.1)
            + {"a": 0.8, "b": 0.0, "c": 0.4}[flat["clustering.method"]])


def run(module, p, sampler, trials=TRIALS, warm_start=None, journal=None):
    study = module.Optimizer(space(p), sampler=sampler, journal=journal,
                             warm_start=warm_start)
    suggestions = []
    for params in study.suggestions(trials):
        suggestions.append(params)
        study.tell(params, objective(params))
    return suggestions, study.best


@pytest.mark.parametrize("sampler,seed,warm", [
    ("TPESampler", 0, None), ("TPESampler", 42, WARM),
    ("RandomSampler", 3, None)])
def test_suggestions_equal_jax(sampler, seed, warm):
    ours = run(optimizer, parameter, getattr(optimizer, sampler)(seed=seed),
               warm_start=warm)
    theirs = run(jax_optimizer, jax_parameter,
                 getattr(jax_optimizer, sampler)(seed=seed), warm_start=warm)
    assert ours == theirs
    if warm is not None:
        assert ours[0][0] == WARM
    assert len({json.dumps(s, sort_keys=True) for s in ours[0]}) == TRIALS


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_journals_resume_across_packages(tmp_path, writer, reader):
    packages = {"port": (optimizer, parameter),
                "jax": (jax_optimizer, jax_parameter)}
    journal = tmp_path / "journal.jsonl"
    module, p = packages[writer]
    run(module, p, module.TPESampler(seed=5), trials=12, journal=journal)
    lines = journal.read_text().splitlines()
    assert [json.loads(line)["trial"] for line in lines] == list(range(12))
    # a resumed study holds the writer's history and continues it
    module, p = packages[reader]
    resumed = module.Optimizer(space(p), journal=journal,
                               sampler=module.TPESampler(seed=6))
    assert len(resumed.history) == 12
    following = []
    for params in resumed.suggestions(4):
        following.append(params)
        resumed.tell(params, objective(params))
    assert len(journal.read_text().splitlines()) == 16
    # the writer's package, resumed from the same 12 lines, agrees
    module, p = packages[writer]
    (tmp_path / "copy.jsonl").write_text("\n".join(lines) + "\n")
    again = module.Optimizer(space(p), journal=tmp_path / "copy.jsonl",
                             sampler=module.TPESampler(seed=6))
    expected = []
    for params in again.suggestions(4):
        expected.append(params)
        again.tell(params, objective(params))
    assert following == expected
    assert resumed.best == again.best


def test_flatten_and_unflatten_match_jax():
    nested = {"a": {"b": {"c": 1, "d": 2}}, "e": 3}
    assert optimizer.flatten_params(nested) == \
        jax_optimizer.flatten_params(nested)
    assert optimizer.unflatten_params({"a.b.c": 1, "e": 3}) == \
        jax_optimizer.unflatten_params({"a.b.c": 1, "e": 3})
    assert set(optimizer.flatten_space(space(parameter))) == \
        set(jax_optimizer.flatten_space(space(jax_parameter)))
