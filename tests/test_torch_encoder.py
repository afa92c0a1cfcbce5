"""The port's BERT encoder and embedding service against the JAX package's:
the same seeded numpy inputs and weights through both, on the CPU.

Tolerances: hidden states atol 1e-5, rtol 1e-4 and embeddings atol 1e-5
against JAX (two float32 computations of the same expressions, summed in
other orders); atol 2e-4, rtol 2e-3 against a random-init
``transformers.BertModel`` (as ``tests/test_encoder.py`` holds JAX to it);
the hashing encoder bit for bit.
"""

from __future__ import annotations

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from githubrepostorag_tpu import embedding as j_embedding
from githubrepostorag_tpu.config import reload_settings as j_reload_settings
from githubrepostorag_tpu.models import encoder as j_encoder
from githubrepostorag_tpu_torch import config as t_config
from githubrepostorag_tpu_torch import embedding
from githubrepostorag_tpu_torch.embedding import HashingTextEncoder, TorchBertTextEncoder
from githubrepostorag_tpu_torch.models import encoder
from githubrepostorag_tpu_torch.models.convert import encoder_params_from_jax
from githubrepostorag_tpu_torch.models.encoder import BertConfig
from githubrepostorag_tpu_torch.models.safetensors_io import save_file

transformers = pytest.importorskip("transformers")

CFG = BertConfig.tiny()
J_CFG = j_encoder.BertConfig.tiny()
WORDS = ("def", "class", "return", "import", "self", "value", "index", "store", "query",
         "passage", "search", "vector", "node", "tree", "the", "a", "of", "to", "in", "is")


@pytest.fixture(scope="module")
def weights():
    """The JAX tree (numpy leaves, x4 so attention is not near uniform)
    and the port's tree converted from it, both float32 on the CPU."""
    jp = jax.tree.map(lambda x: np.asarray(x) * (4.0 if x.ndim >= 2 else 1.0),
                      j_encoder.init_params(J_CFG, jax.random.PRNGKey(0)))
    return jp, encoder_params_from_jax(jp, CFG, device="cpu")


@pytest.fixture(autouse=True)
def _fresh_encoder():
    embedding.set_encoder(None)
    t_config.reload_settings()
    yield
    embedding.set_encoder(None)
    t_config.reload_settings()


def _ids_mask(rng, b, s, lens):
    ids = rng.integers(0, CFG.vocab_size, size=(b, s))
    mask = np.zeros((b, s), dtype=np.int64)
    for i, n in enumerate(lens):
        mask[i, :n] = 1
    return ids, mask


def test_forward_and_embed_match_jax(weights):
    jp, tp = weights
    rng = np.random.default_rng(0)
    ids, mask = _ids_mask(rng, 3, 16, [16, 9, 0])  # full, padded, no real token
    j_h = np.asarray(j_encoder.forward(jp, J_CFG, jnp.asarray(ids, jnp.int32),
                                       jnp.asarray(mask, jnp.int32)))
    t_h = encoder.forward(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(t_h, j_h, atol=1e-5, rtol=1e-4)
    assert np.isfinite(t_h).all()  # -1e30, not -inf: the empty row is uniform, not NaN
    j_e = np.asarray(j_encoder.embed(jp, J_CFG, jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(mask, jnp.int32)))
    t_e = encoder.embed(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert t_e.dtype == np.float32
    np.testing.assert_allclose(t_e, j_e, atol=1e-5)


def test_float64_tree_is_the_checking_path(weights):
    """A float64 tree computes in float64 throughout (the chip script's
    reference): within float32 rounding of the float32 path."""
    _, tp = weights
    rng = np.random.default_rng(1)
    ids, mask = _ids_mask(rng, 2, 32, [32, 5])
    p64 = jax.tree.map(lambda t: t.double(), tp)
    e32 = encoder.embed(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    e64 = encoder.embed(p64, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    assert e64.dtype == torch.float64
    np.testing.assert_allclose(e32.numpy(), e64.numpy(), atol=1e-5)


def test_padding_leaves_real_rows_unchanged(weights):
    _, tp = weights
    rng = np.random.default_rng(2)
    ids, mask = _ids_mask(rng, 1, 8, [5])
    small = encoder.embed(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    ids2 = np.zeros((4, 16), dtype=np.int64)
    mask2 = np.zeros((4, 16), dtype=np.int64)
    ids2[0, :8], mask2[0, :8] = ids[0], mask[0]
    ids2[0, 8:] = 7  # padding positions hold tokens: masked out all the same
    ids2[1:, :3], mask2[1:, :3] = 9, 1
    big = encoder.embed(tp, CFG, torch.from_numpy(ids2), torch.from_numpy(mask2))
    np.testing.assert_allclose(big[0].numpy(), small[0].numpy(), atol=1e-6)


def test_matches_transformers_bert():
    hf_cfg = transformers.BertConfig(
        vocab_size=256, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    model = transformers.BertModel(hf_cfg).eval()
    tp = encoder.params_from_hf_state_dict(model.state_dict(), CFG, device="cpu")
    rng = np.random.default_rng(3)
    ids, mask = _ids_mask(rng, 2, 11, [11, 7])
    with torch.no_grad():
        ref = model(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask)).last_hidden_state
    ours = encoder.forward(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(ours[0].numpy(), ref[0].numpy(), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(ours[1, :7].numpy(), ref[1, :7].numpy(), atol=2e-4, rtol=2e-3)


def test_init_params_is_seeded_and_sized():
    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return encoder.init_params(CFG, g, device="cpu")

    a, b, c = draw(5), draw(5), draw(6)
    assert a["layers"]["wq"].shape == (CFG.num_layers, CFG.hidden_size, CFG.hidden_size)
    assert a["layers"]["w1"].shape == (CFG.num_layers, CFG.hidden_size, CFG.intermediate_size)
    assert a["word_embeddings"].dtype == torch.float32
    assert torch.equal(a["layers"]["w2"], b["layers"]["w2"])
    assert not torch.equal(a["layers"]["w2"], c["layers"]["w2"])
    assert torch.equal(a["layers"]["ln_ffn_w"], torch.ones(CFG.num_layers, CFG.hidden_size))


def test_entry_points_need_a_card_unless_cpu(weights):
    _, tp = weights
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encoder.init_params(CFG, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchBertTextEncoder(tp, CFG, tokenizer=None)


def _write_vocab(path) -> str:
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "query", ":", "passage"]
    vocab += list(WORDS) + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab += [f"##{chr(c)}" for c in range(ord("a"), ord("z") + 1)]
    vocab += [str(d) for d in range(10)] + ["(", ")", "_", ".", ",", "=", "##_"]
    assert len(vocab) <= CFG.vocab_size
    path.write_text("\n".join(vocab) + "\n")
    return str(path)


def _texts(rng, n):
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(1, 40)))) for _ in range(n)]


def test_text_encoder_matches_jax(weights, tmp_path, monkeypatch):
    """Same tokenizer, same texts: the same prefixes, the same batches in
    the same order, the same padded shapes and ids, the same vectors."""
    jp, tp = weights
    tok = transformers.BertTokenizerFast(vocab_file=_write_vocab(tmp_path / "vocab.txt"))
    seen = {"jax": [], "torch": []}
    j_embed, t_embed = j_encoder.embed, encoder.embed

    def spy(side, fn):
        def wrapped(params, cfg, ids, mask):
            seen[side].append((np.asarray(ids).copy(), np.asarray(mask).copy()))
            return fn(params, cfg, ids, mask)
        return wrapped

    monkeypatch.setattr(j_encoder, "embed", spy("jax", j_embed))
    monkeypatch.setattr(embedding, "embed", spy("torch", t_embed))
    kw = dict(max_length=CFG.max_position_embeddings, batch_size=4)
    j_enc = j_embedding.JaxBertTextEncoder(jp, J_CFG, tok, **kw)
    t_enc = TorchBertTextEncoder(tp, CFG, tok, device="cpu", **kw)
    texts = _texts(np.random.default_rng(4), 10)
    for kind in ("passage", "query"):
        j_out, t_out = j_enc.encode(texts, kind=kind), t_enc.encode(texts, kind=kind)
        np.testing.assert_allclose(t_out, j_out, atol=1e-5)
    assert len(seen["torch"]) == len(seen["jax"]) == 6  # 10 texts in batches of 4, twice
    for (ji, jm), (ti, tm) in zip(seen["jax"], seen["torch"]):
        np.testing.assert_array_equal(ti, ji)  # shape bucket, row order, prefix tokens
        np.testing.assert_array_equal(tm, jm)
    assert seen["torch"][0][0][0, 1] == tok.convert_tokens_to_ids("passage")
    assert seen["torch"][3][0][0, 1] == tok.convert_tokens_to_ids("query")


def test_warmup_covers_every_encode_shape(weights):
    _, tp = weights

    class CharTokenizer:
        def __call__(self, texts, truncation, max_length, padding):
            return {"input_ids": [[(ord(c) % 250) + 1 for c in t[:max_length]] for t in texts]}

    enc = TorchBertTextEncoder(tp, CFG, CharTokenizer(), max_length=64, batch_size=8,
                               e5_prefixes=False, device="cpu")
    assert enc.length_buckets() == [16, 32, 64] and enc.row_buckets() == [8]
    assert enc.warmup() == 3
    warmed = set(enc.shapes)
    enc.encode(["ab"] * 3 + ["x" * 30] * 8 + ["y" * 200] * 5)
    enc.encode(["z"])
    assert enc.shapes == warmed  # live traffic met no new shape


def test_hashing_encoder_bit_for_bit():
    texts = ["def ingest_component(repo, namespace)", "", "x x x x y", "Ünïcode wörds 42",
             "the ingest_component function handles a repo " * 5]
    for dim in (64, 384):
        np.testing.assert_array_equal(HashingTextEncoder(dim).encode(texts),
                                      j_embedding.HashingTextEncoder(dim).encode(texts))


def test_get_encoder_falls_back_to_hashing(monkeypatch, caplog):
    monkeypatch.setenv("EMBED_MODEL", "/nonexistent/path")
    t_config.reload_settings()
    with caplog.at_level(logging.WARNING):
        enc = embedding.get_encoder()
    assert isinstance(enc, HashingTextEncoder) and enc.dim == 384
    assert "falling back to the lexical hashing encoder" in caplog.text
    assert embedding.get_encoder() is enc  # process-wide


def test_get_encoder_loads_a_checkpoint_like_jax(weights, tmp_path, monkeypatch):
    """A local checkpoint dir (config.json, safetensors, tokenizer files):
    both packages' from_pretrained give the same vectors; the port's
    get_encoder builds on the device it is given."""
    _, tp = weights
    ckpt = tmp_path / "bert-ckpt"
    ckpt.mkdir()
    tok = transformers.BertTokenizerFast(vocab_file=_write_vocab(tmp_path / "vocab.txt"))
    tok.save_pretrained(str(ckpt))
    (ckpt / "config.json").write_text(json.dumps({
        "vocab_size": CFG.vocab_size, "hidden_size": CFG.hidden_size,
        "intermediate_size": CFG.intermediate_size, "num_hidden_layers": CFG.num_layers,
        "num_attention_heads": CFG.num_heads,
        "max_position_embeddings": CFG.max_position_embeddings, "model_type": "bert"}))
    hf = {"embeddings.word_embeddings.weight": tp["word_embeddings"],
          "embeddings.position_embeddings.weight": tp["position_embeddings"],
          "embeddings.token_type_embeddings.weight": tp["token_type_embeddings"],
          "embeddings.LayerNorm.weight": tp["ln_embed_w"],
          "embeddings.LayerNorm.bias": tp["ln_embed_b"]}
    names = {"wq": "attention.self.query", "wk": "attention.self.key",
             "wv": "attention.self.value", "wo": "attention.output.dense",
             "w1": "intermediate.dense", "w2": "output.dense"}
    for i in range(CFG.num_layers):
        pre = f"bert.encoder.layer.{i}."
        for w, name in names.items():
            hf[pre + name + ".weight"] = tp["layers"][w][i].T.contiguous()
            hf[pre + name + ".bias"] = tp["layers"]["b" + w[1:]][i]
        for ln, name in (("ln_attn", "attention.output.LayerNorm"),
                         ("ln_ffn", "output.LayerNorm")):
            hf[pre + name + ".weight"] = tp["layers"][ln + "_w"][i]
            hf[pre + name + ".bias"] = tp["layers"][ln + "_b"][i]
    save_file(hf, ckpt / "model.safetensors")
    monkeypatch.setenv("EMBED_MODEL", str(ckpt))
    t_config.reload_settings()
    j_reload_settings()
    enc = embedding.get_encoder(device="cpu")
    assert isinstance(enc, TorchBertTextEncoder) and enc.device == torch.device("cpu")
    assert not enc.e5_prefixes  # the dir's name does not say e5
    j_enc = j_embedding.JaxBertTextEncoder.from_pretrained(str(ckpt))
    texts = _texts(np.random.default_rng(5), 3)
    np.testing.assert_allclose(enc.encode(texts, kind="query"), j_enc.encode(texts, kind="query"),
                               atol=1e-5)
