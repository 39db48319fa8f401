"""Temperature sampling in the port against ``jax.random`` and the JAX
batcher, on the CPU:

* ``threefry.uniform`` and ``threefry.gumbel`` are ``jax.random.uniform``
  and ``jax.random.gumbel`` bit for bit (the Gumbel noise needs XLA's own
  f32 logarithm, ``log32``, and a correctly rounded fused multiply-add);
* ``temperature_sample`` draws the token ``jax.random.categorical`` draws
  from the same logits and key, over a padded vocabulary;
* the batcher at ``temperature`` > 0 (the reduced qwen3-4b, the JAX
  engine's seed-0 weights bridged, both in f32, one schedule) samples the
  JAX batcher's tokens with a first token that stays greedy, and splits
  its key once per decode step as the reference's does;
* ``run_task`` at ``temperature=0.7`` gives the reference's texts, and a
  sampled task never reads a greedy task's cached answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.models.model as jax_model_mod
import repro_torch.core as P
import repro_torch.core.engines as port_engines
from repro.configs import get_config as jax_get_config
from repro.data import qa_examples as jax_qa
from repro.models import params as jax_pm
from repro.serve import steps as jax_steps
from repro_torch.configs import get_config
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.serve import steps
from repro_torch.stats import threefry

MAX_TOKENS, N_SLOTS, MAX_LEN, T = 8, 4, 64, 0.7


def _port_key(jkey):
    return torch.from_numpy(np.asarray(jax.random.key_data(jkey)).astype(np.int64))


def _keys(seed, n):
    k = jax.random.key(seed)
    out = []
    for _ in range(n):
        k, sub = jax.random.split(k)
        out.append(sub)
    return out


@pytest.mark.parametrize("shape", [(7,), (4, 1000), (3, 5, 33)])
@pytest.mark.parametrize("seed", [0, 11])
def test_uniform_and_gumbel_equal_jax_random(seed, shape):
    for jkey in _keys(seed, 3):
        pkey = _port_key(jkey)
        np.testing.assert_array_equal(
            threefry.uniform(pkey, shape).numpy(),
            np.asarray(jax.random.uniform(jkey, shape, jnp.float32)))
        np.testing.assert_array_equal(
            threefry.uniform(pkey, shape, minval=-2.5, maxval=3.0).numpy(),
            np.asarray(jax.random.uniform(jkey, shape, jnp.float32, -2.5, 3.0)))
        np.testing.assert_array_equal(
            threefry.gumbel(pkey, shape).numpy(),
            np.asarray(jax.random.gumbel(jkey, shape, jnp.float32)))


def test_log32_is_xla_log_bit_for_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(300_000).astype(np.float32) + np.float32(1e-30),
        (rng.random(100_000) * 1e6).astype(np.float32) + np.float32(1e-3),
        np.float32([np.finfo(np.float32).tiny, 5.96e-8, 87.33, 1 - 2**-24, 2**-23,
                    0.5, 1.0, 2.0, np.sqrt(0.5)]),
    ])
    got = threefry.log32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.log(x)))
    # torch's own log differs in the last bit often enough to matter
    assert (torch.log(torch.from_numpy(x)).numpy() != got).sum() > 1000


def test_fma32_rounds_once():
    """The product and the sum rounded together: here the f64 sum lands on
    an f32 tie (half-even rounds it down to 2^30) while the exact value is
    2^-40 above the tie, so the fused result is 2^30 + 128."""
    a = torch.tensor([-64.0 * (1 + 2**-23)], dtype=torch.float32)
    b, c = 1 - 2**-23, 2.0**30 + 128
    assert (a.double() * b + c).float().item() == 2.0**30
    assert threefry._fma32(a, b, c).item() == 2.0**30 + 128
    rng = np.random.default_rng(1)
    x, y, z = (torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
               for _ in range(3))
    exact = (x.double() * y.double() + z.double()).float()
    assert torch.equal(threefry._fma32(x, y.double(), z.double()), exact)


@pytest.mark.parametrize("vocab", [1000, 997])
@pytest.mark.parametrize("temperature", [0.0, 0.3, 0.7, 1.5])
def test_temperature_sample_equals_jax(vocab, temperature):
    rng = np.random.default_rng(vocab)
    logits = (rng.standard_normal((6, 1000)) * 3).astype(np.float32)
    for jkey in _keys(3, 4):
        want = np.asarray(jax_steps.temperature_sample(
            jnp.asarray(logits), vocab, temperature, jkey))
        got = steps.temperature_sample(torch.from_numpy(logits), vocab, temperature,
                                       _port_key(jkey)).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got < vocab).all()
    if temperature > 0:
        # the noisy scores themselves, bit for bit
        masked = jnp.where(jnp.arange(1000) < vocab, jnp.asarray(logits), -jnp.inf)
        jscore = jax.random.gumbel(jkey, (6, 1000), jnp.float32) + masked / temperature
        t = torch.tensor(temperature, dtype=torch.float32)
        pscore = threefry.gumbel(_port_key(jkey), (6, 1000)) + torch.from_numpy(
            np.array(masked)) / t
        np.testing.assert_array_equal(pscore.numpy(), np.asarray(jscore))


# -- the batcher ------------------------------------------------------------------


class _JaxF32:
    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def param_specs(self):
        return self.model.param_specs()

    def cache_specs(self, *a, **kw):
        return self.model.cache_specs(*a, **kw)

    def prefill(self, params, batch, cache):
        return self.model.prefill(params, batch, cache, dtype=jnp.float32)

    def decode_step(self, params, tokens, cache, positions):
        return self.model.decode_step(params, tokens, cache, positions, dtype=jnp.float32)


class _PortF32(TransformerLM):
    def prefill(self, *a, **kw):
        return super().prefill(*a, dtype=torch.float32, **kw)

    def decode_step(self, *a, **kw):
        return super().decode_step(*a, dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def bridged():
    jcfg = jax_get_config("qwen3-4b").reduced()
    model = jax_model_mod.build_model(jcfg, remat="none")
    tree = jax.tree.map(np.asarray, jax_pm.init_params(jax.random.key(0), model.param_specs()))
    return params_from_jax(tree, get_config("qwen3-4b").reduced(), device="cpu",
                           dtype=torch.float32)


@pytest.fixture
def f32(monkeypatch, bridged):
    build = jax_model_mod.build_model
    monkeypatch.setattr(jax_model_mod, "build_model", lambda c, **kw: _JaxF32(build(c, **kw)))
    monkeypatch.setattr(port_engines, "build_model", lambda cfg: _PortF32(cfg))
    monkeypatch.setattr(port_engines, "init_params", lambda cfg, seed, device: bridged)


def _models(temperature):
    kw = dict(model_name="qwen3-4b", reduced=True, seed=0, max_tokens=MAX_TOKENS,
              temperature=temperature)
    return R.EngineModelConfig(provider="local", **kw), P.EngineModelConfig(**kw)


def test_batcher_samples_the_jax_batchers_tokens(f32):
    prompts = [f"what is known about enzymes (case {i})?" for i in range(6)]
    out = {}
    for temperature in (0.0, T):
        jm, pm = _models(temperature)
        jeng = R.engines.LocalJaxEngine(jm, n_slots=N_SLOTS, max_len=MAX_LEN)
        peng = P.TorchLocalEngine(pm, n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu")
        # one batch through each: the same schedule in both batchers
        jres = jeng.infer_batch([R.InferenceRequest(p, MAX_TOKENS) for p in prompts])
        pres = peng.infer_batch([P.InferenceRequest(p, MAX_TOKENS) for p in prompts])
        assert [r.text for r in pres] == [r.text for r in jres]
        assert [r.output_tokens for r in pres] == [r.output_tokens for r in jres]
        steps_run = peng.serving_stats()["steps"]
        assert steps_run == jeng.serving_stats()["steps"] > 0
        # one key split a decode step: the keys agree after the run
        np.testing.assert_array_equal(
            peng.batcher.key.numpy(),
            np.asarray(jax.random.key_data(jeng._scheduler.key)).astype(np.int64))
        out[temperature] = [r.text for r in pres]
        if temperature > 0:
            again = P.TorchLocalEngine(pm, n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu")
            assert [r.text for r in again.infer_batch(
                [P.InferenceRequest(p, MAX_TOKENS) for p in prompts])] == out[T]
    assert out[T] != out[0.0]
    # the first token comes from the greedy prefill at any temperature
    first = [t.split()[0] for t in out[0.0]]
    assert [t.split()[0] for t in out[T]] == first


def test_sampled_run_task_equals_the_reference_and_skips_greedy_hits(f32, tmp_path):
    rows = jax_qa(6)
    kw = {"engine_kwargs": {"n_slots": 8, "max_len": MAX_LEN}}
    texts = {}
    for mod, m_of in ((R, 0), (P, 1)):
        cache = str(tmp_path / ("jax" if mod is R else "port"))
        with mod.EvalSession(**({} if mod is R else {"device": "cpu"}), **kw) as s:
            for temperature in (0.0, T):
                task = mod.EvalTask(
                    "hot", model=_models(temperature)[m_of],
                    # one worker, one prompt at a time: the same schedule in
                    # both packages, whatever the threads' timing
                    inference=mod.InferenceConfig(cache_dir=cache, use_service=False,
                                                  n_workers=1),
                    metrics=(mod.MetricConfig("token_f1"),))
                res = s.run_task(rows, task)
                # the temperature is part of the cache key: no greedy hits
                assert res.cache_stats["hits"] == 0 and res.engine_stats["calls"] == 6
                texts[mod, temperature] = res.responses
    assert texts[P, T] == texts[R, T] and texts[P, 0.0] == texts[R, 0.0]
    assert texts[P, T] != texts[P, 0.0]
