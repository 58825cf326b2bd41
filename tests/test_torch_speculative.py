"""The port's sampled and speculative paged decoding (CPU) against the
JAX package on the same converted weights and numpy prompts: the n-gram
drafter bit for bit, sampled tokens at horizon 1 and 8, speculative
greedy tokens in the three acceptance regimes, speculative sampled
tokens, EOS and budgets on f32 and int8 pages, the speculation
telemetry, the page table after rollback, the reference's errors and
the deprecated ``greedy=`` shim."""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime import serve as jserve  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.serve import (GREEDY, PagedServer,  # noqa: E402
                                       SamplingConfig, draft_ngram)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several test processes
    on the host's cores, and torch's per-process thread pools
    oversubscribe them (the draws here slowed 30x under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return cfg, (jmodel, jparams), (tmodel, tparams)


def _port(models, prompts, **kw):
    """The port's server with ``prompts`` admitted."""
    _, _, (tm, tp) = models
    ts = PagedServer(tm, tp, device="cpu", **{"page_size": 4,
                                              "hbm_pages": 64, **kw})
    for i, p in enumerate(prompts):
        ts.add_request(i, p)
    return ts


def _servers(models, prompts, **kw):
    """(JAX server, port server), each with ``prompts`` admitted."""
    _, (jm, jp), _ = models
    js = jserve.PagedServer(jm, jp, dtype=jnp.float32,
                            **{"page_size": 4, "hbm_pages": 64, **kw})
    for i, p in enumerate(prompts):
        js.add_request(i, p)
    return js, _port(models, prompts, **kw)


def _jsc(sc):
    return jserve.SamplingConfig(sc.temperature, sc.top_p, sc.seed)


# a constant stream is the drafter's best case (alpha ~ 1)
def _const_prompts(n=3, length=12):
    return [np.full(length + i, c, np.int32)
            for i, c in enumerate((5, 9, 13)[:n])]


def _regime_prompts(cfg, regime):
    rng = np.random.default_rng(0)
    return {
        "alpha0": [rng.integers(0, cfg.vocab_size, 9, dtype=np.int32)
                   for _ in range(3)],
        "partial": [rng.integers(0, cfg.vocab_size, 9, dtype=np.int32),
                    np.full(12, 5, np.int32), np.full(13, 9, np.int32)],
        "alpha1": _const_prompts(),
    }[regime]


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------

DRAFT_CASES = {
    # suffix 1 2 3 recurs at sites 5 and 2: the earlier site has the
    # longer runway and drafts 1 2 3 1
    "copies_matched_successors": ([[1, 2, 3, 1, 2, 3, 1, 2, 3, -1, -1, -1]],
                                  [9], 4, [[1, 2, 3, 1]]),
    # the final trigram 7 8 9 appears nowhere earlier: no draft
    "requires_min_match": ([[9, 1, 2, 9, 5, 7, 8, 9]], [8], 3,
                           [[-1, -1, -1]]),
    "short_history_is_silent": ([[4, 4, -1, -1]], [2], 3, [[-1, -1, -1]]),
}


def _draft_both(hist, hist_len, n_draft):
    hist = np.asarray(hist, np.int32)
    hist_len = np.asarray(hist_len, np.int32)
    want = np.asarray(jserve.draft_ngram(jnp.asarray(hist),
                                         jnp.asarray(hist_len), n_draft))
    got = draft_ngram(torch.from_numpy(hist), torch.from_numpy(hist_len),
                      n_draft)
    assert got.dtype == torch.int32
    return got.numpy(), want


@pytest.mark.parametrize("case", DRAFT_CASES)
def test_draft_ngram_reference_cases(case):
    hist, hist_len, n_draft, expect = DRAFT_CASES[case]
    got, want = _draft_both(hist, hist_len, n_draft)
    assert np.array_equal(got, want)
    assert got.tolist() == expect


def test_draft_ngram_matches_jax_on_drawn_histories():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None, derandomize=True)
    # a few history widths (each is one JAX trace), any lengths, tokens
    # from a small alphabet (repeats to match) and -1 garbage
    @given(st.integers(1, 3), st.sampled_from([1, 8, 37]),
           st.integers(1, 8), st.integers(2, 5), st.data())
    def check(b, t, n_draft, alphabet, data):
        hist = np.asarray(data.draw(st.lists(
            st.lists(st.integers(-1, alphabet), min_size=t, max_size=t),
            min_size=b, max_size=b)), np.int32)
        hist_len = np.asarray(data.draw(st.lists(
            st.integers(0, t), min_size=b, max_size=b)), np.int32)
        got, want = _draft_both(hist, hist_len, n_draft)
        assert np.array_equal(got, want), (hist, hist_len, n_draft)
    check()


# ---------------------------------------------------------------------------
# PagedServer, port against JAX
# ---------------------------------------------------------------------------

SAMPLED = SamplingConfig(temperature=0.8, top_p=0.9, seed=42)


@pytest.mark.parametrize("horizon", [None, 8], ids=["h1", "h8"])
def test_sampled_tokens_match_jax(models, horizon):
    cfg = models[0]
    prompts = _regime_prompts(cfg, "partial")
    js, ts = _servers(models, prompts)
    want = js.decode(12, horizon=horizon, sampling=_jsc(SAMPLED))
    got = ts.decode(12, horizon=horizon, sampling=SAMPLED)
    assert got == want
    # seeded, and the seed matters
    other = dataclasses.replace(SAMPLED, seed=7)
    assert _port(models, prompts).decode(
        12, horizon=horizon, sampling=other) != got


@pytest.mark.parametrize("regime", ["alpha0", "partial", "alpha1"])
def test_spec_greedy_matches_jax_and_per_token(models, regime):
    cfg = models[0]
    prompts = _regime_prompts(cfg, regime)
    js, ts = _servers(models, prompts)
    want = js.decode(24, horizon=8, speculative=True)
    got = ts.decode(24, horizon=8, speculative=True)
    assert got == want
    assert ts.speculation_stats() == js.speculation_stats()
    assert got == _port(models, prompts).decode(24)
    st = ts.speculation_stats()
    if regime == "alpha1":
        assert st["alpha"] > 0.7 and st["accepted"] > 24


def test_spec_sampled_matches_jax(models):
    """Greedy priming fills the history with repeats, then a sampled
    speculative phase drafts and verifies against Gumbel targets."""
    sc = SamplingConfig(temperature=0.05, top_p=0.95, seed=3)
    js, ts = _servers(models, _const_prompts(2))
    assert ts.decode(12, horizon=8) == js.decode(12, horizon=8)
    want = js.decode(16, horizon=8, speculative=True, sampling=_jsc(sc))
    got = ts.decode(16, horizon=8, speculative=True, sampling=sc)
    assert got == want
    st = ts.speculation_stats()
    assert st == js.speculation_stats()
    assert st["passes"] > 0 and st["drafted"] > 0


def test_spec_sampled_equals_plain_sampled(models):
    """Gumbel coupling: the speculative sampled stream is the plain
    sampled stream, token for token (here at a temperature where drafts
    are accepted and rejected both)."""
    sc = SamplingConfig(temperature=0.3, top_p=0.9, seed=5)

    def run(spec):
        ts = _port(models, _const_prompts())
        ts.decode(8, horizon=8)
        return ts.decode(16, horizon=8, speculative=spec, sampling=sc), ts
    plain, _ = run(False)
    spec, ts = run(True)
    assert spec == plain
    assert ts.speculation_stats()["passes"] > 0


@pytest.mark.parametrize("page_dtype", ["fp32", "int8"])
def test_spec_eos_and_budgets_match_jax(models, page_dtype):
    prompts = _const_prompts()
    probe = _port(models, prompts, page_dtype=page_dtype)
    eos = int(probe.decode(8)[0][3])
    budgets = {0: 3, 1: 8, 2: 6}
    kw = dict(horizon=8, eos_id=eos, budgets=budgets, speculative=True)
    js, ts = _servers(models, prompts, page_dtype=page_dtype)
    got = ts.decode(8, **kw)
    assert got == js.decode(8, **kw)
    assert {s: ts.table.length(s) for s in range(3)} == \
        {s: js.table.length(s) for s in range(3)}
    assert ts.tier_stats() == js.tier_stats()
    # and equal to the plain horizon on the port itself
    plain = _port(models, prompts, page_dtype=page_dtype)
    assert plain.decode(8, **{**kw, "speculative": False}) == got


def test_spec_rollback_leaves_table_identical(models):
    prompts = _const_prompts()

    def run(spec):
        ts = _port(models, prompts)
        ts.decode(16, horizon=8, speculative=spec)
        return ts
    a, b = run(False), run(True)
    assert {s: a.table.length(s) for s in a.sequence_ids()} == \
           {s: b.table.length(s) for s in b.sequence_ids()}
    assert a.table.resident_pages == b.table.resident_pages
    assert len(b.table._pinned) == 0
    assert b.tier_stats()["horizon_pages_rolled_back"] > 0 or \
        b.speculation_stats()["alpha"] == 1.0


def test_verify_pass_takes_a_materialised_table(models, monkeypatch):
    """A verify pass hands the kernel one table row a query row,
    contiguous (the decode form); an expanded, stride-0 table would take
    the chunk form, which reads one sequence for every row."""
    from repro_torch.kernels import ops
    seen = []
    inner = ops.paged_attention

    def spy(q, k_pages, v_pages, page_table, lengths):
        seen.append((q.shape[0], page_table.stride(0),
                     page_table.is_contiguous()))
        return inner(q, k_pages, v_pages, page_table, lengths)
    monkeypatch.setattr(ops, "paged_attention", spy)
    ts = _port(models, _const_prompts())
    ts.decode(24, horizon=8, speculative=True)
    assert ts.speculation_stats()["passes"] > 0
    verify = [s for s in seen if s[0] == 4 * 8]      # pow2(3) rows x H
    assert verify and all(stride > 0 and contiguous
                          for _, stride, contiguous in verify)


def test_history_follows_the_reference(models):
    """The drafter's corpus: prompt, pending token, emitted tokens, a
    rewritten pending token, dropped with the sequence."""
    js, ts = _servers(models, _const_prompts(2))
    for server in (js, ts):
        server.decode(5, horizon=4, speculative=True)
        server.set_pending(1, 7)
    assert ts._history == js._history
    ts.free_sequence(0)
    assert list(ts._history) == [1]


# ---------------------------------------------------------------------------
# errors, the greedy= shim, GREEDY
# ---------------------------------------------------------------------------


def test_decode_speculative_requires_fusable_horizon(models):
    ts = _port(models, _const_prompts())
    with pytest.raises(ValueError, match="speculative"):
        ts.decode(4, horizon=1, speculative=True)


def test_greedy_shim_deprecated_but_equivalent(models):
    prompts = _const_prompts()
    ref = _port(models, prompts).decode(8)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = _port(models, prompts).decode(8, greedy=True)
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert out == ref
    with pytest.raises(ValueError, match="greedy=False"), \
            pytest.warns(DeprecationWarning):
        _port(models, prompts).decode(8, greedy=False)


def test_decode_takes_the_reference_positional_order(models):
    """decode(n_tokens, greedy, seqs): the third positional argument is
    the sequence subset, as in the JAX server."""
    prompts = _const_prompts()
    ts = _port(models, prompts)
    with pytest.warns(DeprecationWarning):
        out = ts.decode(4, True, [1])
    assert list(out) == [1]
    assert out[1] == _port(models, prompts).decode(4, seqs=[1])[1]


def test_greedy_sampling_config_is_argmax(models):
    prompts = _const_prompts()
    ref = _port(models, prompts).decode(8, horizon=4)
    assert _port(models, prompts).decode(
        8, horizon=4, sampling=GREEDY) == ref
    assert _port(models, prompts).decode(8, sampling=GREEDY) == ref
