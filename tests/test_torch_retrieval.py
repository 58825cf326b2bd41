"""The port's RetrievalFrontend (CPU) against the JAX package's: the same
corpus, queries and converted weights give the same retrieved ids, the
same assembled prompts, and the same greedy tokens and prefix hits when
the prompts are admitted to the two PagedServers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_arch as jget_arch  # noqa: E402
from repro.core import StoragePool as JPool  # noqa: E402
from repro.core import analytics_blob as jblob  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.runtime.retrieval import RetrievalFrontend as JFrontend  # noqa: E402
from repro.runtime.serve import PagedServer as JServer  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core.extent_store import analytics_blob  # noqa: E402
from repro_torch.core.storage_pool import StoragePool  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.runtime.retrieval import RetrievalFrontend  # noqa: E402
from repro_torch.runtime.serve import PagedServer  # noqa: E402

EXT_CFG = {"n_pages": 16, "page_rows": 8, "n_cols": 16}
N_DOCS, CHUNK = 40, 4


def _corpus(seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (N_DOCS, CHUNK), dtype=np.int32)
    emb = rng.normal(size=(N_DOCS, 12)).astype(np.float32)
    emb[17] = emb[5]                      # a tie: doc 5 ranks first
    template = rng.integers(0, vocab, 6, dtype=np.int32)
    queries = rng.normal(size=(3, 12)).astype(np.float32)
    queries[2] = emb[5]
    return tokens, emb, template, queries


def _pools():
    jp = JPool(1, extent_cfg=EXT_CFG)
    tp = StoragePool(1, extent_cfg={**EXT_CFG, "device": "cpu"})
    jp.broadcast_pull("isp-analytics", jblob())
    tp.broadcast_pull("isp-analytics", analytics_blob())
    return jp, tp


@pytest.mark.parametrize("metric,force", [("dot", "device"),
                                          ("cosine", "device"),
                                          ("dot", "host")])
def test_build_prompts_match_jax(metric, force):
    tokens, emb, template, queries = _corpus()
    jp, tp = _pools()
    jfe = JFrontend(jp, corpus_tokens=tokens, template=template, k=3,
                    metric=metric)
    tfe = RetrievalFrontend(tp, corpus_tokens=tokens, template=template,
                            k=3, metric=metric, device="cpu")
    assert jfe.ingest(emb) == tfe.ingest(emb)
    tails = [np.arange(i + 1, dtype=np.int32) for i in range(3)]
    jprompts, jhits = jfe.build_prompts(queries, tails, force=force)
    tprompts, thits = tfe.build_prompts(queries, tails, force=force)
    assert [h["ids"] for h in thits] == [h["ids"] for h in jhits]
    assert thits[2]["ids"][:2] == [5, 17]
    for t, j in zip(tprompts, jprompts):
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, j)
    for t, j in zip(thits, jhits):
        np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-6)
    assert tfe.stats == jfe.stats
    assert tfe.corpus_tokens.device.type == "cpu"
    assert tfe.preferred_node(tprompts[0]) is None


def test_rag_serving_tokens_and_prefix_hits_match_jax():
    cfg = dataclasses.replace(jget_arch("granite_3_2b").reduced(),
                              n_layers=2, vocab_size=64)
    jmodel = jget_model(cfg, compute_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = get_model(ArchConfig(**dataclasses.asdict(cfg)))
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    tokens, emb, template, queries = _corpus(1, cfg.vocab_size)
    jp, tp = _pools()
    jsrv = JServer(jmodel, jparams, page_size=4, hbm_pages=48,
                   dtype=jnp.float32)
    tsrv = PagedServer(tmodel, tparams, page_size=4, hbm_pages=48,
                       device="cpu")
    jfe = JFrontend(jp, jsrv, corpus_tokens=tokens, template=template, k=2)
    tfe = RetrievalFrontend(tp, tsrv, corpus_tokens=tokens,
                            template=template, k=2)
    jfe.ingest(emb)
    tfe.ingest(emb)
    outs = []
    for fe in (jfe, tfe):
        got = []
        for wave in range(2):                # the second wave rides the
            for i in range(2):               # cached template + chunks
                qt = np.asarray([wave + 1, i + 3], np.int32)
                _, prompt, hit = fe.submit(10 * wave + i, queries[0], qt,
                                           force="device")
                got.append((list(prompt), hit["ids"]))
            got.append(fe.server.decode(3))
        stats = fe.server.tier_stats()
        outs.append((got, stats["prefix_hits"], stats["prefix_tokens"]))
    assert outs[1] == outs[0]
    assert outs[1][1] > 0
