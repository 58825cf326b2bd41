"""The port's token sampling (CPU) against the JAX package: the threefry
keys, fold_in chains, random bits and uniforms bit for bit against
``jax.random``, Gumbel noise within 2 ulp, ``sampling_log_probs`` and
``sampled_token`` against the JAX ones, and the launcher's sampled
paths (the dense draws against the JAX launcher's ``pick``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.runtime import serve as jserve  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.runtime import prng  # noqa: E402
from repro_torch.runtime.serve import (GREEDY, SamplingConfig,  # noqa: E402
                                       sampled_token, sampling_log_probs)

SEEDS = (0, 1, 2**31 - 1, 2**32 + 5)
DATA = (0, 1, 7, 2**31 - 1)
SHAPES = ((1,), (64,), (49155,), (3, 7))
# the two logs of -log(-log(u)) are each within an ulp of XLA's; the
# noise is held to 2 ulp of max(1, |g|)
GUMBEL_ULPS = 2
# log-softmax of f32 logits: exp/log differ from XLA's by an ulp or two,
# and an ulp of a log-prob near -16 is 1.9e-6: 1e-6 absolute plus 1e-6
# relative
LOG_PROB_TOL = 1e-6
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them (the draws here slowed 30x under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_chains_bit_identical(seed):
    jkey, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert np.array_equal(_words(jkey), tkey.numpy())
    # a chain of folds, each over the previous key
    for d in DATA:
        jkey, tkey = jax.random.fold_in(jkey, d), prng.fold_in(tkey, d)
        assert np.array_equal(_words(jkey), tkey.numpy()), d


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_bit_identical(seed, shape):
    for d in DATA:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        tkey = prng.fold_in(prng.prng_key(seed), d)
        assert np.array_equal(
            _words(jax.random.bits(jkey, shape, jnp.uint32)),
            prng.random_bits(tkey, shape).numpy())
        for lo, hi in ((0.0, 1.0), (TINY, 1.0)):
            want = np.asarray(jax.random.uniform(jkey, shape, jnp.float32,
                                                 minval=lo, maxval=hi))
            got = prng.uniform(tkey, shape, lo, hi).numpy()
            assert got.dtype == np.float32 and got.shape == shape
            assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp(seed):
    for d in DATA:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        tkey = prng.fold_in(prng.prng_key(seed), d)
        for shape in SHAPES:
            want = np.asarray(jax.random.gumbel(jkey, shape, jnp.float32))
            got = prng.gumbel(tkey, shape).numpy()
            lim = GUMBEL_ULPS * np.spacing(np.maximum(1, np.abs(want)))
            assert np.all(np.abs(got - want) <= lim), (seed, d, shape)


def test_batched_keys_fold_and_draw_per_row():
    """One call over a [B] batch of keys equals B single-key calls, and
    the JAX draws of each row."""
    rows = torch.arange(5) * 1000 + 3
    keys = prng.fold_in(prng.fold_in(prng.prng_key(9), rows), rows + 1)
    bits = prng.random_bits(keys, (33,))
    assert bits.shape == (5, 33)
    for i, r in enumerate(rows.tolist()):
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), r),
                                r + 1)
        assert np.array_equal(_words(jk), keys[i].numpy())
        assert np.array_equal(_words(jax.random.bits(jk, (33,), jnp.uint32)),
                              bits[i].numpy())


def _logits(rng, rows, v, scale=3.0):
    return (rng.standard_normal((rows, v)) * scale).astype(np.float32)


@pytest.mark.parametrize("top_p", [0.5, 0.9, 1.0])
@pytest.mark.parametrize("temperature", [0.5, 1.0, 1.5])
def test_sampling_log_probs_match_jax(temperature, top_p):
    logits = _logits(np.random.default_rng(int(temperature * 10)), 4, 4099)
    want = np.asarray(jserve.sampling_log_probs(
        jnp.asarray(logits), jnp.float32(temperature), jnp.float32(top_p)))
    got = sampling_log_probs(torch.from_numpy(logits), temperature,
                             top_p).numpy()
    kept = want > -1e29
    # the same nucleus for every token whose mass before it (exact, in
    # float64) is clear of top_p; near it, the f32 running sums of the
    # two sides (XLA's blocked scan, torch's) may round either way, as
    # at top_p = 1 where the f32 sum reaches 1.0 inside the tail
    p = np.exp(logits.astype(np.float64) / temperature)
    p /= p.sum(-1, keepdims=True)
    order = np.argsort(-p, axis=-1, kind="stable")
    srt = np.take_along_axis(p, order, -1)
    before = np.empty_like(p)
    np.put_along_axis(before, order, np.cumsum(srt, -1) - srt, -1)
    clear = np.abs(before - top_p) > 1e-6
    assert clear.sum(-1).min() >= 8
    assert np.array_equal((got > -1e29)[clear], kept[clear])
    both = kept & (got > -1e29)
    np.testing.assert_allclose(got[both], want[both], atol=LOG_PROB_TOL,
                               rtol=LOG_PROB_TOL)
    if top_p < 1.0:
        assert not kept.all()


def test_sampling_log_probs_keep_cutoff_ties():
    """Probabilities 0.4, 0.2, 0.2, 0.2: the nucleus of mass 0.5 reaches
    the first 0.2, and every token at the cutoff probability stays, on
    both sides."""
    logits = np.log(np.array([[0.4, 0.2, 0.2, 0.2]], np.float32))
    want = np.asarray(jserve.sampling_log_probs(
        jnp.asarray(logits), jnp.float32(1.0), jnp.float32(0.5)))
    got = sampling_log_probs(torch.from_numpy(logits), 1.0, 0.5).numpy()
    assert (want > -1e29).all() and (got > -1e29).all()
    np.testing.assert_allclose(np.exp(got), np.exp(want), atol=LOG_PROB_TOL)
    # the reference's own case: the tail past the 0.6 line goes
    tail = np.log(np.array([[0.5, 0.3, 0.15, 0.05]], np.float32))
    p = np.exp(sampling_log_probs(torch.from_numpy(tail), 1.0, 0.6).numpy())
    assert p[0, 2] < 1e-6 and p[0, 3] < 1e-6
    np.testing.assert_allclose(p[0, :2], [0.625, 0.375], atol=1e-5)


def test_sampled_token_matches_jax_200_draws():
    """200 seeded (seed, stream, position) draws at vocab 49155,
    temperatures 0.5-1.5 and top-p 0.5-1.0: the same token."""
    rng = np.random.default_rng(2024)
    logits = _logits(rng, 8, 49155, scale=4.0)
    for i in range(200):
        row = logits[i % 8]
        sc = SamplingConfig(temperature=float(rng.uniform(0.5, 1.5)),
                            top_p=float(rng.uniform(0.5, 1.0)),
                            seed=int(rng.integers(0, 2**31)))
        stream = int(rng.integers(0, 2**31))
        position = int(rng.integers(1, 4097))
        want = jserve.sampled_token(
            row, jserve.SamplingConfig(sc.temperature, sc.top_p, sc.seed),
            stream, position)
        assert sampled_token(torch.from_numpy(row), sc, stream,
                             position) == want, i


def test_greedy_sampled_token_is_argmax():
    row = _logits(np.random.default_rng(3), 1, 1000)[0]
    want = int(np.argmax(row))
    assert sampled_token(torch.from_numpy(row), GREEDY, 5, 9) == want
    assert sampled_token(torch.from_numpy(row), None, 5, 9) == want


def test_dense_draws_equal_jax_launcher_pick():
    """The dense launcher's selection (``dense_pick``) against the JAX
    launcher's ``pick``: ``sampling_log_probs`` + Gumbel of
    ``fold_in(PRNGKey(seed), step)`` over the [B, V] block."""
    sc = SamplingConfig(temperature=0.8, top_p=0.9, seed=0)
    jkey = jax.random.PRNGKey(sc.seed)
    tkey = prng.prng_key(sc.seed)
    rng = np.random.default_rng(11)
    for step in range(6):
        lg = _logits(rng, 4, 49155)
        lp = jserve.sampling_log_probs(jnp.asarray(lg), jnp.float32(0.8),
                                       jnp.float32(0.9))
        g = jax.random.gumbel(jax.random.fold_in(jkey, step), lp.shape,
                              jnp.float32)
        want = np.asarray(jnp.argmax(lp + g, -1))
        got = launcher.dense_pick(torch.from_numpy(lg), sc, tkey, step)
        assert got.tolist() == want.tolist(), step
    greedy = launcher.dense_pick(torch.from_numpy(lg), None, None, 0)
    assert greedy.tolist() == np.argmax(lg, -1).tolist()


def test_launcher_sampled_speculative_paged_runs_on_cpu():
    out = launcher.main([
        "--arch", "granite-3-2b", "--reduced", "--paged", "--speculative",
        "--horizon", "8", "--temperature", "0.8", "--top-p", "0.9",
        "--requests", "2", "--prompt-len", "12", "--gen", "9",
        "--device", "cpu"])
    assert {k: len(v) for k, v in out.items()} == {0: 9, 1: 9}


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-3b"])
def test_launcher_dense_temperature_runs_on_cpu(arch):
    argv = ["--arch", arch, "--reduced", "--requests", "2",
            "--prompt-len", "6", "--gen", "4", "--device", "cpu"]
    sampled = launcher.main(argv + ["--temperature", "0.8", "--top-p", "0.9"])
    assert {k: len(v) for k, v in sampled.items()} == {0: 4, 1: 4}
    # seeded: a rerun draws the same tokens
    assert launcher.main(argv + ["--temperature", "0.8", "--top-p",
                                 "0.9"]) == sampled


@pytest.mark.parametrize("flags", [["--speculative"],
                                   ["--paged", "--speculative"],
                                   ["--paged", "--speculative", "--horizon",
                                    "1"]])
def test_launcher_speculative_needs_paged_and_horizon(flags):
    with pytest.raises(SystemExit, match="--speculative needs"):
        launcher.main(["--arch", "granite-3-2b", "--reduced", "--device",
                       "cpu", *flags])
