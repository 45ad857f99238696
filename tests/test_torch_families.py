"""Port parity for the audio (musicgen-large) and vlm (paligemma-3b)
families on their smoke configs: JAX params carried over with
``params_from_numpy``, inputs made with numpy from a seed, float32.

(a) the prefix-LM mask (``layers.mask_tile``) against the JAX one over a
    grid of positions, windows and prefix lengths, exactly;
(b) ``forward`` logits and ``loss`` in dense, lut_train and int8
    lut_infer (the JAX projections as its tests run them on the CPU);
(c) the dense-cache ``prefill`` and a ``decode`` chain (greedy for vlm,
    fed the next frames for audio) against the JAX ``prefill`` /
    ``decode`` and against the port's own ``forward`` at the same
    positions;
(d) what the port refuses for them: the paged entry points, both
    engines, and left padding (``pad_lens``) on a vlm, whose first rows
    hold its image prefix;
and a checkpoint round trip of audio's own leaves.

Tolerance: logits and losses at atol 1e-4 (every int8 projection is an
exact sum; attention, norms and heads sum in another order); greedy
argmax identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.models.layers import mask_tile as jmask_tile  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.models.layers import mask_tile  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve import BatchToCompletionEngine, Engine  # noqa: E402
from repro_torch.tree import tree_flatten_with_path, tree_map  # noqa: E402

ATOL = 1e-4
ARCHS = ["musicgen-large", "paligemma-3b"]
B, S, PRE = 2, 12, 8           # batch, sequence (text for vlm), prompt
MODES = {
    "dense": (JQC(mode="dense"), TQC(mode="dense")),
    "lut_train": (JQC(mode="lut_train"), TQC(mode="lut_train")),
    "lut_infer": (JQC(mode="lut_infer", lut_dtype="int8"),
                  TQC(mode="lut_infer", lut_dtype="int8")),
}


def _batch(cfg, seed):
    """A batch of the family's kind as numpy arrays (float32 embeddings,
    int32 tokens and labels)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       (B, S, cfg.num_codebooks)).astype(
                    np.int32)}
    return {"patch_embeds": rng.standard_normal(
                (B, cfg.num_patches, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}


def _jax(arrays):
    return {k: jnp.asarray(a) for k, a in arrays.items()}


def _torch(arrays):
    return {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """A JAX smoke model of the family initialised in lut_train, and the
    port's model on the CPU with those params carried over, by mode
    (lut_infer: after the JAX ``precompute_model``, int8)."""
    arch = request.param
    jm = JModel(jconfigs.get_smoke_config(arch))
    tm = TModel(tconfigs.get_smoke_config(arch), device="cpu")
    train = jm.init(jax.random.PRNGKey(3), JQC(mode="lut_train"))
    params_j = {mode: train for mode in MODES}
    params_j["lut_infer"] = precompute_model(train, MODES["lut_infer"][0])
    params_t = {mode: params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), tm.cfg, device="cpu")
        for mode, p in params_j.items()}
    return jm, params_j, tm, params_t


def test_mask_tile_matches_jax_exactly():
    for q_off in (0, 5):
        for s, t in ((1, 9), (7, 12), (12, 12)):
            qi = np.arange(s) + q_off
            kj = np.arange(t)
            for window in (0, 3):
                for prefix in (0, 4, 9, 20):
                    want = np.asarray(jmask_tile(jnp.asarray(qi),
                                                 jnp.asarray(kj), window,
                                                 prefix))
                    got = mask_tile(torch.from_numpy(qi),
                                    torch.from_numpy(kj), window, prefix)
                    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_and_loss_match_jax(carried, mode):
    """Logits of every position (vlm: the patches too; audio: every
    codebook) and the loss with its parts; audio's labels are shifted by
    one frame, a vlm's loss covers its text tokens alone."""
    jm, params_j, tm, params_t = carried
    qj, qt = MODES[mode]
    arrays = _batch(tm.cfg, 11)
    lg_j, loss_j, met_j = jax.jit(
        lambda p, b: (jm.forward(p, b, qj)[0], *jm.loss(p, b, qj)))(
        params_j[mode], _jax(arrays))
    batch = _torch(arrays)
    with torch.no_grad():
        lg_t, _ = tm.forward(params_t[mode], batch, qt)
        loss_t, met_t = tm.loss(params_t[mode], batch, qt)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL)
    want_shape = ((B, S, tm.cfg.num_codebooks, tm.cfg.vocab_size)
                  if tm.cfg.family == "audio"
                  else (B, tm.cfg.num_patches + S, tm.cfg.vocab_size))
    assert tuple(lg_t.shape) == want_shape
    for key in ("ce", "recon", "loss"):
        np.testing.assert_allclose(met_t[key].item(), float(met_j[key]),
                                   atol=ATOL, rtol=ATOL)
    assert (met_t["recon"].item() > 0) == (mode == "lut_train")
    if tm.cfg.family == "vlm":      # the text's cross-entropy alone
        lp = torch.log_softmax(lg_t[:, tm.cfg.num_patches - 1:-1], -1)
        ce = -torch.gather(lp, -1, batch["tokens"].long()[..., None]).mean()
        np.testing.assert_allclose(met_t["ce"].item(), ce.item(), rtol=1e-6)


def test_dense_prefill_and_decode_chain_match_jax_and_forward(carried):
    """int8 lut_infer: prefill of the first PRE tokens (vlm: after its
    patches) or frames, then S - PRE decode steps, through the JAX
    package and the port: logits within ATOL and argmax equal at every
    step, the caches equal; and the port's chain against its own
    ``forward`` over the whole sequence at the same positions. vlm
    decodes greedily (each step feeds the last argmax); audio is fed the
    batch's next frames (the stub frontend gives no token feedback)."""
    jm, params_j, tm, params_t = carried
    cfg, (qj, qt) = tm.cfg, MODES["lut_infer"]
    pj, pt = params_j["lut_infer"], params_t["lut_infer"]
    arrays = _batch(cfg, 21)
    audio = cfg.family == "audio"
    if audio:
        pre = {"embeds": arrays["embeds"][:, :PRE]}
    else:
        pre = {"patch_embeds": arrays["patch_embeds"],
               "tokens": arrays["tokens"][:, :PRE]}
    max_seq = cfg.num_patches + S + 4
    cache_j = jm.init_cache(B, max_seq)
    cache_t = tm.init_cache(B, max_seq)
    lg_j, cache_j = jax.jit(lambda p, b, c: jm.prefill(p, b, c, qj))(
        pj, _jax(pre), cache_j)
    with torch.no_grad():
        lg_t, cache_t = tm.prefill(pt, _torch(pre), cache_t, qt)
    assert cache_t["pos"] == int(cache_j["pos"]) == \
        cfg.num_patches + PRE
    dec_j = jax.jit(lambda p, t, c: jm.decode(p, t, c, qj))
    chain_j, chain_t, fed = [np.asarray(lg_j)], [lg_t.numpy()], []
    for t in range(PRE, S):
        if audio:
            nxt = arrays["embeds"][:, t:t + 1]
        else:
            nxt = np.asarray(chain_j[-1]).argmax(-1)[:, None].astype(
                np.int32)
            np.testing.assert_array_equal(chain_t[-1].argmax(-1),
                                          nxt[:, 0])
        fed.append(nxt)
        lg_j, cache_j = dec_j(pj, jnp.asarray(nxt), cache_j)
        with torch.no_grad():
            lg_t, cache_t = tm.decode(pt, torch.from_numpy(nxt), cache_t,
                                      qt)
        chain_j.append(np.asarray(lg_j))
        chain_t.append(lg_t.numpy())
    for got, want in zip(chain_t, chain_j):
        np.testing.assert_allclose(got, want, atol=ATOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t["layers"][key].numpy(),
                                   np.asarray(cache_j["layers"][key]),
                                   atol=1e-5)
    # the port's chain against its own forward over what it was fed
    if audio:
        whole = {"embeds": arrays["embeds"]}
    else:
        whole = {"patch_embeds": arrays["patch_embeds"],
                 "tokens": np.concatenate([pre["tokens"]] + fed[:-1], 1)}
    with torch.no_grad():
        full, _ = tm.forward(pt, _torch(whole), qt)
    off = 0 if audio else cfg.num_patches
    for i, got in enumerate(chain_t[:-1] if not audio else chain_t):
        np.testing.assert_allclose(got, full[:, off + PRE - 1 + i].numpy(),
                                   atol=ATOL)


def test_refusals_paged_engines_and_vlm_left_padding(carried):
    """Paged serving and the engines take token prompts only, as the JAX
    package's paged entry points do; a vlm takes no ``pad_lens``: the JAX
    package would mask its image prefix, whose rows come first."""
    _, _, tm, params_t = carried
    pt, qt = params_t["lut_infer"], MODES["lut_infer"][1]
    toks = torch.zeros((1, 4), dtype=torch.int32)
    table = torch.zeros((1, 2), dtype=torch.int32)
    kv = tm.init_paged_cache(16, 8, 2)
    one = torch.zeros((1,), dtype=torch.int32)
    for call in (
            lambda: tm.prefill_paged(pt, toks, kv, table, 0, 0, 4, qt),
            lambda: tm.decode_paged(pt, toks[:, :1], kv, table, one, qt),
            lambda: tm.verify_paged(pt, toks, kv, table, one, one + 4, qt)):
        with pytest.raises(NotImplementedError, match="token-prompt"):
            call()
    for engine in (Engine, BatchToCompletionEngine):
        with pytest.raises(NotImplementedError, match="token prompts"):
            engine(tm, pt, qt, batch_size=2, max_seq=32)
    arrays = _torch(_batch(tm.cfg, 31))
    pad = torch.tensor([2, 0], dtype=torch.int32)
    cache = tm.init_cache(B, tm.cfg.num_patches + S + 1)
    if tm.cfg.family == "vlm":
        with pytest.raises(NotImplementedError, match="image prefix"):
            tm.prefill(pt, arrays, cache, qt, pad_lens=pad)
        with pytest.raises(NotImplementedError, match="image prefix"):
            tm.decode(pt, arrays["tokens"][:, :1], cache, qt, pad_lens=pad)
    else:                   # audio takes left padding as dense prompts do
        with torch.no_grad():
            lg, cache = tm.prefill(pt, {"embeds": arrays["embeds"]}, cache,
                                   qt, pad_lens=pad)
        assert tuple(lg.shape) == (B, tm.cfg.num_codebooks,
                                   tm.cfg.vocab_size)


def test_checkpoint_round_trip_carries_audio_leaves(tmp_path):
    """``in_proj`` and ``heads`` (and no ``embed``) save and load bit for
    bit, in float32 and bf16, as every other leaf does."""
    tm = TModel(tconfigs.get_smoke_config("musicgen-large"), device="cpu")
    params = tm.init(torch.Generator().manual_seed(2),
                     TQC(mode="lut_train"))
    assert "embed" not in params and {"in_proj", "heads"} <= set(params)
    for dtype in (torch.float32, torch.bfloat16):
        tree = tree_map(lambda t: t.to(dtype), params)
        path = str(tmp_path / f"ckpt_{str(dtype).split('.')[-1]}")
        save_pytree(path, tree)
        back = load_pytree(path, tree_map(torch.zeros_like, tree))
        got = dict(tree_flatten_with_path(back))
        for key, t in tree_flatten_with_path(tree):
            assert got[key].dtype == t.dtype and torch.equal(got[key], t)
