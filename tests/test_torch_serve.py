"""The port's serving layer against the JAX package's on the CPU: request
retry (``repro_torch.distributed.server``), the serve CLI and its
``generate`` loop (``repro_torch.launch.serve``), and the sampling draws
(``repro_torch.core.prng.gumbel`` / ``categorical``).

Tolerances: the Gumbel noise is ``-log(-log(u))`` of a bit-equal uniform;
torch's and XLA's float32 ``log`` may differ by an ulp at each of the
two logs, so the noise is held to atol 4.8e-7 (4 ulp at 1, where the
outer log nears 0) plus rtol 1e-6, and the sampled indices to equality.
The greedy and sampled token ids of ``generate`` are held to equality
with the JAX package's serve loop on the same (converted) parameters, and
its logits to the model tests' float32 limits (atol = rtol = 1e-4).
"""
import io
import random
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (caps torch threads under xdist)

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.distributed import server as jax_server
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import prng
from repro_torch.distributed import server
from repro_torch.launch import serve

CPU = torch.device("cpu")


class FakeClock:
    """A clock that moves only when slept on, or by ``work`` per call."""

    def __init__(self, work=0.0):
        self.t, self.work, self.sleeps = 0.0, work, []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s

    def run(self, fn):
        def timed():
            self.t += self.work
            return fn()
        return timed


def _flaky(fails, exc=RuntimeError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise exc(f"attempt {calls['n']}")
        return "ok"
    return fn, calls


def _schedule(mod, policy, fails, work=0.0):
    clock = FakeClock(work)
    fn, calls = _flaky(fails)
    retried = []
    try:
        out = mod.call_with_retry(
            clock.run(fn), policy, clock=clock, sleep=clock.sleep,
            rng=random.Random(3), on_retry=lambda a, e: retried.append(
                (a, type(e).__name__)))
    except mod.RetriesExhausted as e:
        out = ("exhausted", type(e.__cause__).__name__)
    return out, calls["n"], clock.sleeps, retried


@pytest.mark.parametrize("fails", [0, 1, 2, 5])
@pytest.mark.parametrize("kw", [{}, {"max_attempts": 5, "base_delay": 0.5,
                                     "max_delay": 1.0, "jitter": 0.0}])
def test_retry_schedule_matches_the_reference(fails, kw):
    got = _schedule(server, server.RetryPolicy(**kw), fails)
    want = _schedule(jax_server, jax_server.RetryPolicy(**kw), fails)
    assert got == want
    assert got[0] == ("ok" if fails < (kw.get("max_attempts", 3))
                      else ("exhausted", "RuntimeError"))


def test_retry_timeout_counts_as_a_failure():
    policy = server.RetryPolicy(max_attempts=2, timeout=0.5)
    out, n, sleeps, retried = _schedule(server, policy, 0, work=1.0)
    assert out == ("exhausted", "RequestTimeout") and n == 2
    assert retried == [(0, "RequestTimeout")] and len(sleeps) == 1
    assert _schedule(jax_server, jax_server.RetryPolicy(
        max_attempts=2, timeout=0.5), 0, work=1.0) == (out, n, sleeps,
                                                       retried)


def test_retry_policy_validates_and_filters():
    with pytest.raises(ValueError):
        server.RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        server.RetryPolicy(jitter=1.5)
    fn, calls = _flaky(1, exc=KeyError)
    with pytest.raises(KeyError):   # not in retry_on: raised at once
        server.call_with_retry(fn, server.RetryPolicy(
            retry_on=(RuntimeError,)), sleep=lambda s: None)
    assert calls["n"] == 1


@pytest.mark.parametrize("shape,seed", [((4, 512), 0), ((3, 1000), 7),
                                        ((2, 151936), 11)])
def test_categorical_matches_jax_float32(shape, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    for i in range(4):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        tkey = prng.fold_in(prng.prng_key(seed), i)
        g_want = np.asarray(jax.random.gumbel(jkey, shape, jnp.float32))
        g_got = prng.gumbel(tkey, shape, torch.float32, CPU).numpy()
        np.testing.assert_allclose(g_got, g_want, rtol=1e-6, atol=4.8e-7)
        want = np.asarray(jax.random.categorical(jkey, logits))
        got = prng.categorical(tkey, torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)


def test_categorical_matches_jax_bfloat16():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(4, 300)) * 2).astype(np.float32)
    jl = jnp.asarray(logits, jnp.bfloat16)
    tl = torch.from_numpy(logits).to(torch.bfloat16)
    for i in range(4):
        jkey = jax.random.fold_in(jax.random.PRNGKey(5), i)
        tkey = prng.fold_in(prng.prng_key(5), i)
        g_want = np.asarray(jax.random.gumbel(jkey, (4, 300), jnp.bfloat16)
                            .astype(jnp.float32))
        g_got = prng.gumbel(tkey, (4, 300), torch.bfloat16, CPU)
        assert g_got.dtype == torch.bfloat16
        np.testing.assert_array_equal(g_got.float().numpy(), g_want)
        np.testing.assert_array_equal(
            prng.categorical(tkey, tl).numpy(),
            np.asarray(jax.random.categorical(jkey, jl)))


def test_prompts_are_the_reference_cli_prompts():
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.randint(key, (3, 17), 0, 151936))
    got = prng.randint_n(prng.prng_key(4), 3 * 17, 0, 151936, CPU)
    np.testing.assert_array_equal(got.reshape(3, 17).numpy(), want)


def _jax_serve_loop(params, cfg, prompts, gen, temperature, seed):
    """``repro.launch.serve``'s loop, verbatim, on given parameters."""
    key = jax.random.PRNGKey(seed)
    S = prompts.shape[1]
    logits, cache = JM.prefill(params, cfg, prompts, cache_len=S + gen + 1)
    tok = logits[:, -1].argmax(-1)[:, None].astype(jnp.int32)
    out, seen = [tok], [logits[:, -1]]
    for i in range(gen - 1):
        logits, cache = JM.decode_step(params, cfg, cache, tok)
        if temperature > 0:
            k = jax.random.fold_in(key, i)
            tok = jax.random.categorical(
                k, logits[:, -1] / temperature)[:, None].astype(jnp.int32)
        else:
            tok = logits[:, -1].argmax(-1)[:, None].astype(jnp.int32)
        out.append(tok)
        seen.append(logits[:, -1])
    return np.asarray(jnp.concatenate(out, 1)), np.stack(seen, 1)


def _check_generate(arch, temperature):
    jcfg = jax_reduced(jax_get_config(arch))
    tcfg = reduced(get_config(arch))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 12),
                                          0, jcfg.vocab))
    want_tok, want_lg = _jax_serve_loop(jp, jcfg, jnp.asarray(prompts), 6,
                                        temperature, 0)
    tok, lg = serve.generate(tp, tcfg, torch.from_numpy(prompts), 6,
                             temperature, seed=0)
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_allclose(lg.numpy(), want_lg, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_the_reference_serve_loop(temperature):
    _check_generate("qwen3_8b", temperature)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_rwkv6_matches_the_reference_serve_loop(temperature):
    """RWKV6: prefill runs the chunked scan (prompt 12: the sequential
    scan on both sides) and decode carries the state and token shifts."""
    _check_generate("rwkv6_1b6", temperature)


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen3_8b", "--reduced", "--batch", "2", "--prompt-len",
     "16", "--gen", "5", "--device", "cpu"],
    ["--arch", "paper_sim", "--reduced", "--batch", "3", "--prompt-len",
     "9", "--gen", "4", "--device", "cpu", "--temperature", "0.7",
     "--backend", "torch"],
    ["--arch", "rwkv6_1b6", "--reduced", "--batch", "2", "--prompt-len",
     "16", "--gen", "5", "--device", "cpu"],
])
def test_serve_cli_on_the_cpu(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(argv)
    lines = buf.getvalue().splitlines()
    B, gen = int(argv[argv.index("--batch") + 1]), \
        int(argv[argv.index("--gen") + 1])
    assert lines[0] == "generated token ids:" and lines[-1] == "done"
    rows = [eval(line) for line in lines[1:-1]]   # noqa: S307 — our output
    vocab = reduced(get_config(argv[1])).vocab
    assert len(rows) == B and all(len(r) == gen for r in rows)
    assert all(0 <= t < vocab for r in rows for t in r)
    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        serve.main(argv)
    assert buf2.getvalue() == buf.getvalue()      # seeded: reproducible


def test_serve_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--gen", "2"])
