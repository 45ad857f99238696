"""Port parity at model level: the smoke models in lut_infer (int8 LUTs),
JAX params carried over with ``params_from_numpy``, through chunked
``prefill_paged`` and a greedy ``decode_paged`` chain, against the JAX
package with its Pallas flash-decode kernel (interpret): qwen1.5-4b
(G=1, tied head), and yi-9b (G=4, untied head), gemma3-4b (G=2, D=16,
window 8, one global layer in 6) and gemma3-27b (window 8, one global
layer in 3) at contexts past their window. The config copies and the
port's registry are held against the JAX package's.

Tolerance: logits at atol 1e-4 (float32; every projection is an exact
int8 sum, the difference comes from attention/norm sums in another order);
greedy argmax identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402

ATOL = 1e-4
PS, MAX_SEQ, N_PAGES, CHUNK = 8, 32, 10, 4


@pytest.fixture(scope="module")
def pair():
    cfg_j = jcfg.smoke_config()
    jm = JModel(cfg_j)
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", flash="pallas")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(0), JQC(mode="lut_train")), qc_j)
    tree = jax.tree_util.tree_map(np.asarray, params_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(tree, tm.cfg, device="cpu")
    qc_t = TQC(mode="lut_infer", lut_dtype="int8")
    return jm, params_j, qc_j, tm, params_t, qc_t


PORTED = ("qwen1.5-4b", "yi-9b", "gemma3-4b", "gemma3-27b")


def test_config_copies_match_jax_field_for_field():
    for arch in PORTED:
        for name in ("get_config", "get_smoke_config"):
            want = dataclasses.asdict(getattr(jconfigs, name)(arch))
            got = dataclasses.asdict(getattr(tconfigs, name)(arch))
            assert got == want, (arch, name)
    for name in ("config", "smoke_config"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == \
            dataclasses.asdict(getattr(jcfg, name)())


def test_registry_names_the_roadmap_item_of_unported_configs():
    assert tuple(tconfigs.ARCH_NAMES) == PORTED
    assert set(PORTED) < set(jconfigs.ARCH_NAMES)
    for arch in set(jconfigs.ARCH_NAMES) - set(PORTED):
        for fn in (tconfigs.get_config, tconfigs.get_smoke_config):
            with pytest.raises(NotImplementedError, match="item 9"):
                fn(arch)
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-model")


def test_params_from_numpy_unstacks_layers(pair):
    jm, params_j, _, tm, params_t, _ = pair
    blocks = params_t["blocks"]
    assert len(blocks) == tm.cfg.num_layers
    wq = blocks[1]["attn"]["wq"]
    assert wq["lut"].dtype == torch.int8 and wq["lut_scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(
        wq["lut"].numpy(), np.asarray(params_j["blocks"]["attn"]["wq"]["lut"][1]))


def test_port_init_builds_the_same_tree_as_jax(pair):
    """Model.init in lut_infer: same keys, shapes and dtypes as the JAX
    tree after precompute + strip (no dense weight left)."""
    _, params_j, _, tm, params_t, qc_t = pair
    own = tm.init(torch.Generator().manual_seed(0), qc_t)
    ref = {k: v for k, v in params_t.items() if k != "blocks"}
    for k, v in ref.items():
        assert own[k].shape == v.shape and own[k].dtype == v.dtype
    for lt, lr in zip(own["blocks"], params_t["blocks"]):
        for part in ("attn", "mlp"):
            for name, p in lr[part].items():
                if name == "norm":
                    continue
                assert set(lt[part][name]) == set(p) - {"w"}
                for key, t in lt[part][name].items():
                    assert t.shape == p[key].shape and t.dtype == p[key].dtype


def test_prefill_and_decode_chain_match_jax(pair):
    # slot 0: 11-token prompt, slot 1: 6 tokens, slot 2: holds prompt KV
    # but is NOT decoding (positions = -1): its pages must stay untouched
    table = np.full((3, MAX_SEQ // PS), -1, np.int32)
    table[0, :2] = [5, 2]
    table[1, :2] = [0, 7]
    table[2, :1] = [9]
    prompts = [list(range(3, 14)), [40, 41, 42, 43, 44, 45], [7, 8, 9]]
    _chain(*pair, table, prompts, steps=4)


def _carry(arch, seed):
    """A JAX smoke model of ``arch`` in lut_infer (int8), its params
    carried over to the port's model on the CPU."""
    jm = JModel(jconfigs.get_smoke_config(arch))
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", flash="pallas")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(seed), JQC(mode="lut_train")), qc_j)
    tm = TModel(tconfigs.get_smoke_config(arch), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params_j),
                                 tm.cfg, device="cpu")
    return jm, params_j, qc_j, tm, params_t, TQC(mode="lut_infer",
                                                 lut_dtype="int8")


@pytest.mark.parametrize("arch", ["yi-9b", "gemma3-4b", "gemma3-27b"])
def test_gqa_and_window_configs_prefill_and_decode_chain_match_jax(arch):
    """GQA groups, an untied head (yi), head_dim != d_model / heads and
    sliding-window layers (gemma3): prompts of 19 and 13 tokens and a
    5-step decode chain run past the smoke configs' window of 8, so the
    window masks in prefill and in decode."""
    models = _carry(arch, 5)
    cfg = models[3].cfg
    assert cfg.num_heads > cfg.num_kv_heads
    assert cfg.tie_embeddings == ("head" not in models[4])
    table = np.full((3, MAX_SEQ // PS), -1, np.int32)
    table[0, :4] = [5, 2, 8, 1]
    table[1, :3] = [0, 7, 3]
    table[2, :1] = [9]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (19, 13, 3)]
    _chain(*models, table, prompts, steps=5)


def _chain(jm, params_j, qc_j, tm, params_t, qc_t, table, prompts, steps):
    """Chunked prefill of every prompt into its slot, then a greedy decode
    chain of the first two slots (slot 2 not decoding: positions = -1),
    through the JAX package and the port: logits to ATOL, argmax equal,
    the pools equal outside the trash page, slot 2's pages untouched."""
    kv_j = jm.init_paged_cache(3, MAX_SEQ, PS, num_pages=N_PAGES)
    kv_t = tm.init_paged_cache(MAX_SEQ, PS, N_PAGES)
    pf_j = jax.jit(lambda p, t, kv, pt, s, pos, v: jm.prefill_paged(
        p, t, kv, pt, s, pos, v, qc_j))
    dec_j = jax.jit(lambda p, t, kv, pt, pos: jm.decode_paged(
        p, t, kv, pt, pos, qc_j))
    table_t = torch.from_numpy(table)
    last = {}
    for slot, prompt in enumerate(prompts):
        for pos in range(0, len(prompt), CHUNK):
            chunk = prompt[pos:pos + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :len(chunk)] = chunk
            lg_j, kv_j = pf_j(params_j, jnp.asarray(toks), kv_j,
                              jnp.asarray(table), slot, pos, len(chunk))
            lg_t = tm.prefill_paged(params_t, torch.from_numpy(toks), kv_t,
                                    table_t, slot, pos, len(chunk), qc_t)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                       atol=ATOL)
            last[slot] = int(np.argmax(np.asarray(lg_j)[0]))
        assert int(lg_t.argmax()) == last[slot]
    live = np.ones(N_PAGES + 1, bool)
    live[-1] = False                             # trash contents are free
    for key in ("k", "v"):
        np.testing.assert_allclose(kv_t[key].numpy()[:, live],
                                   np.asarray(kv_j[key])[:, live], atol=1e-5)
    slot2_pages = kv_t["k"][:, 9].clone()
    positions = np.array([len(prompts[0]), len(prompts[1]), -1], np.int32)
    toks = np.array([[last[0]], [last[1]], [0]], np.int32)
    for _ in range(steps):
        lg_j, kv_j = dec_j(params_j, jnp.asarray(toks), kv_j,
                           jnp.asarray(table), jnp.asarray(positions))
        lg_t = tm.decode_paged(params_t, torch.from_numpy(toks), kv_t,
                               table_t, torch.from_numpy(positions), qc_t)
        lg_j = np.asarray(lg_j)
        np.testing.assert_allclose(lg_t.numpy()[:2], lg_j[:2], atol=ATOL)
        nxt = lg_j.argmax(-1)
        np.testing.assert_array_equal(lg_t.numpy()[:2].argmax(-1), nxt[:2])
        toks = nxt[:, None].astype(np.int32)
        positions[:2] += 1
    assert torch.equal(kv_t["k"][:, 9], slot2_pages)
    for key in ("k", "v"):
        np.testing.assert_allclose(kv_t[key].numpy()[:, live],
                                   np.asarray(kv_j[key])[:, live], atol=1e-5)
