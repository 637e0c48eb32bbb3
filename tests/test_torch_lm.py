"""Bigram shallow fusion in the port against the JAX package: the LM
table producers, `lm_bias` in the eager decoder (the plain version of
the decode kernel's LM variant), batch and streaming, the kernel
dispatch with an LM, and `eval.evaluate_batch`.

Decoders are compared on the SAME log_probs and table. Tokens, lengths
and timesteps must be equal; scores agree to 1e-5 (torch's and XLA's
exp/log1p differ in the last bits on the CPU); the port's plain decode
is array-equal in its backpointers to JAX's Pallas kernel in interpret
mode.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gasr_tpu.data.dataset import DEFAULT_CHARS, text_to_ids
from gasr_tpu.decoder import beam_search as jbs
from gasr_tpu.decoder import lm as jlm
from gasr_tpu import eval as jeval
from gasr_tpu.ops.pallas.fused_decode import fused_prefix_decode, pack_state

from gasr_tpu_torch import eval as teval
from gasr_tpu_torch.decoder import beam_search as tbs
from gasr_tpu_torch.decoder import bigram_bias_from_arpa, bigram_bias_from_text
from gasr_tpu_torch.ops.cuda import fused_decode

SCORE_TOL = 1e-5
V28 = len(DEFAULT_CHARS) + 1
CORPUS = ["the cat sat on a mat", "a cat ate the meal",
          "that cat is fat", "my cat and their cat nap"] * 3
ARPA_BIGRAM = r"""
\data\
ngram 1=4
ngram 2=2

\1-grams:
-0.5	<s>	-0.30103
-0.60206	a	-0.30103
-0.60206	b	-0.1
-1.0	c	0.0

\2-grams:
-0.30103	a b
-0.69897	<s> a

\end\
"""
ARPA_UNIGRAM = "\n".join(
    ["\\data\\", f"ngram 1={len(DEFAULT_CHARS)}", "", "\\1-grams:"]
    + [f"-1.5\t{'<space>' if c == ' ' else c}\t-0.3" for c in DEFAULT_CHARS]
    + ["", "\\end\\"])


def _lp(rng, T, B, V, kind):
    x = rng.standard_normal((T, B, V)).astype(np.float32)
    if kind == "relu":               # compat_final_relu: exact zeros, raw
        return np.maximum(np.round(x * 2) / 2, 0.0).astype(np.float32)
    if kind == "quantised":          # many exactly tied scores
        x = np.round(x * 2) / 2
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _table(rng, V, scale=2.0):
    """A standard-normal [V+1, V] table with -0.0 planted (the quantized
    table must carry +0.0 there on both sides)."""
    lm = (rng.standard_normal((V + 1, V)) * scale).astype(np.float32)
    lm[::3, ::4] = -0.0
    return lm


def _assert_same_result(got, want):
    for f in ("tokens", "lengths", "timesteps", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("kw", [{}, {"weight": 0.3},
                                {"add_k": 2.0, "offset": 2}])
def test_bigram_from_text_matches_jax(kw):
    V = V28 + kw.get("offset", 1) - 1
    np.testing.assert_array_equal(bigram_bias_from_text(CORPUS, V, **kw),
                                  jlm.bigram_bias_from_text(CORPUS, V, **kw))


@pytest.mark.parametrize("arpa,weight", [(ARPA_BIGRAM, 1.0),
                                         (ARPA_UNIGRAM, 0.2)])
def test_bigram_from_arpa_matches_jax(tmp_path, arpa, weight):
    p = tmp_path / "lm.arpa"
    p.write_text(arpa)
    got = bigram_bias_from_arpa(str(p), V28, weight=weight)
    np.testing.assert_array_equal(
        got, jlm.bigram_bias_from_arpa(str(p), V28, weight=weight))
    assert got.dtype == np.float32 and (got[:, 0] == 0).all()


@pytest.mark.parametrize("W,V,T,B,kind,lens", [
    (8, 7, 9, 3, "random", None),
    (16, 29, 8, 2, "quantised", [8, 3]),
    (100, 47, 5, 2, "relu", None),         # the flagship's W and V
    (64, 129, 5, 2, "random", [5, 2]),     # conformer_s's decode shape
    (64, 255, 4, 2, "quantised", None),    # JAX's LM ceiling
    (128, 128, 3, 1, "random", None),
])
def test_lm_decode_matches_jax_matched(W, V, T, B, kind, lens):
    rng = np.random.default_rng(W * 1000 + V)
    lp, lm = _lp(rng, T, B, V, kind), _table(rng, V)
    jkw = {} if lens is None else {"input_lengths": jnp.asarray(lens)}
    tkw = {} if lens is None else {"input_lengths": torch.tensor(lens)}
    want = jbs.ctc_beam_search(jnp.asarray(lp), beam_width=W, max_len=16,
                               merge_impl="matched", lm_bias=jnp.asarray(lm),
                               **jkw)
    got = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W, max_len=16,
                              lm_bias=torch.from_numpy(lm), **tkw)
    _assert_same_result(got, want)
    plain = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                                max_len=16, **tkw)
    assert not torch.equal(got.scores, plain.scores)


def test_lm_table_is_quantized_once_with_positive_zeros():
    lm = np.array([[-0.0, 1.0 + 2 ** -10], [3.0, -0.0], [0.1, -2.5]],
                  np.float32)
    q = tbs._quantize_lm(torch.from_numpy(lm), 2, "cpu")
    jq = np.asarray(jnp.asarray(lm).astype(jnp.bfloat16).astype(jnp.float32)
                    + 0.0)
    np.testing.assert_array_equal(q.numpy().view(np.int32), jq.view(np.int32))
    assert not np.signbit(q.numpy()[0, 0]) and q[0, 1] == 1.0
    with pytest.raises(ValueError, match=r"\[V\+1, V\]"):
        tbs.ctc_beam_search(torch.zeros(2, 1, 3), beam_width=2,
                            lm_bias=torch.zeros(3, 3))


@pytest.mark.parametrize("W,V,T,B", [(6, 5, 6, 2), (6, 129, 4, 2)])
def test_plain_lm_decode_equals_jax_kernel(W, V, T, B):
    """The port's plain decode against JAX's `fused_prefix_decode(...,
    lm_q=...)` in interpret mode (the shapes of
    tests/test_pallas_decode.py's LM cases)."""
    rng = np.random.default_rng(V)
    lp, lm = _lp(rng, T, B, V, "random"), _table(rng, V)
    lm_q = tbs._quantize_lm(torch.from_numpy(lm), V, "cpu")
    out = fused_prefix_decode(
        jnp.asarray(lp), pack_state(jbs._init_beam(B, W, True)), W=W, V=V,
        blank_id=0, interpret=True, sel_mode="exact",
        lm_q=jnp.asarray(lm).astype(jnp.bfloat16).astype(jnp.float32) + 0.0)
    fin, ys = fused_decode.fused_prefix_decode(
        torch.from_numpy(lp), tbs._init_beam(B, W, "cpu"), 0, lm_q=lm_q)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(out.ys))
    for f in ("h1", "h2", "hp1", "hp2", "last", "length", "live"):
        np.testing.assert_array_equal(
            getattr(fin, f).numpy(),
            np.asarray(getattr(out, f)).astype(getattr(fin, f).numpy().dtype),
            f)
    np.testing.assert_allclose(fin.s1.numpy(), np.asarray(out.s1),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("chunks", [[3, 1, 5], [9]])
def test_lm_streaming_matches_batch_and_jax(chunks):
    W, V, B = 8, 11, 3
    rng = np.random.default_rng(len(chunks))
    lp, lm = _lp(rng, sum(chunks), B, V, "quantised"), _table(rng, V)
    lm_t, lm_j = torch.from_numpy(lm), jnp.asarray(lm)
    st = tbs.streaming_init(B, W, max_len=16, device="cpu")
    jst = jbs.streaming_init(B, W, max_len=16)
    t0 = 0
    for n in chunks:
        st, snap = tbs.streaming_step(st, torch.from_numpy(lp[t0:t0 + n]),
                                      lm_bias=lm_t)
        jst, jsnap = jbs.streaming_step(jst, jnp.asarray(lp[t0:t0 + n]),
                                        lm_bias=lm_j)
        _assert_same_result(snap, jsnap)
        t0 += n
    batch = tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=W,
                                max_len=16, lm_bias=lm_t)
    for f in ("tokens", "lengths", "timesteps", "overflow"):
        assert torch.equal(getattr(snap, f), getattr(batch, f)), f
    assert torch.equal(snap.scores.view(torch.int32),
                       batch.scores.view(torch.int32))


def _jax_use_pallas_lm(merge_impl, W, V):
    try:
        return jbs._use_pallas(merge_impl, "prefix", True, W, V, "exact",
                               jnp.zeros((V + 1, V))), None
    except ValueError as e:
        return None, str(e)


def test_kernel_dispatch_with_lm_follows_jax():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for W in (1, 63, 64, 65, 100, 128, 129):
        for V in (2, 47, 127, 128, 129, 254, 255, 256, 257):
            ok, err = _jax_use_pallas_lm("pallas", W, V)
            for dev in (cpu, cuda):
                if err is None:
                    assert tbs._use_kernels("pallas", "prefix", True, W, V,
                                            dev, has_lm=True) \
                        == (dev.type == "cuda")
                else:
                    with pytest.raises(ValueError) as e:
                        tbs._use_kernels("pallas", "prefix", True, W, V, dev,
                                         has_lm=True)
                    assert str(e.value) == err
            assert tbs._use_kernels("auto", "prefix", True, W, V, cuda,
                                    has_lm=True) == (err is None)
            assert fused_decode.in_envelope(W, V, has_lm=True) \
                == (err is None)


@pytest.mark.parametrize("kw,msg", [
    ({"algorithm": "reference"}, "lm_bias requires the matched-merge"),
    ({"merge_impl": "sort"}, "lm_bias requires the matched-merge"),
    ({"algorithm": "reference", "prob_domain": True},
     "lm_bias requires the matched-merge"),
    ({"algorithm": "reference", "merge_impl": "pallas"},
     "requires the log-domain prefix algorithm"),
])
def test_lm_refused_off_the_matched_path(kw, msg):
    lp = np.log(np.full((3, 1, 4), 0.25, np.float32))
    lm = np.zeros((5, 4), np.float32)
    with pytest.raises(ValueError, match=msg):
        jbs.ctc_beam_search(jnp.asarray(lp), beam_width=2,
                            lm_bias=jnp.asarray(lm), **kw)
    with pytest.raises(ValueError, match=msg):
        tbs.ctc_beam_search(torch.from_numpy(lp), beam_width=2,
                            lm_bias=torch.from_numpy(lm), **kw)


def _logits_for_text(text, corrupt=None, p_main=0.9):
    """[T, 1, V] log-probs spelling `text` (tests/test_lm.py's setting):
    per char one strong frame + one blank frame; corrupt: {pos:
    (wrong_id, p_wrong, p_true)} makes the acoustics prefer a wrong char."""
    rows = []

    def fill(p_used, n):
        return (1.0 - p_used) / (V28 - n)
    for pos, i in enumerate(text_to_ids(text)):
        row = np.full(V28, fill(p_main, 1), np.float64)
        row[i] = p_main
        if corrupt and pos in corrupt:
            wrong, p_w, p_t = corrupt[pos]
            row = np.full(V28, fill(p_w + p_t, 2), np.float64)
            row[wrong] = p_w
            row[i] = p_t
        blank = np.full(V28, fill(p_main, 1), np.float64)
        blank[0] = p_main
        rows += [row, blank]
    return np.log(np.stack(rows))[:, None, :].astype(np.float32)


def test_evaluate_batch_matches_jax_with_and_without_lm(tmp_path):
    q = DEFAULT_CHARS.index("q") + 1
    texts = ["the cat", "a fat cat"]
    lps = [_logits_for_text(texts[0], corrupt={5: (q, 0.46, 0.44)}),
           _logits_for_text(texts[1], corrupt={7: (q, 0.46, 0.44)})]
    bias = bigram_bias_from_text(CORPUS, V28, weight=0.3)
    wers = {}
    for name, lm in (("no_lm", None), ("lm", bias)):
        tot = 0.0
        for lp, ref in zip(lps, texts):
            got = teval.evaluate_batch(
                torch.from_numpy(lp), [ref], beam_width=8,
                lm_bias=None if lm is None else torch.from_numpy(lm))
            want = jeval.evaluate_batch(
                jnp.asarray(lp), [ref], beam_width=8,
                lm_bias=None if lm is None else jnp.asarray(lm))
            assert got == want
            tot += got["wer"]
        wers[name] = tot / len(texts)
    assert wers["no_lm"] > 0.0 and wers["lm"] == 0.0   # fusion repairs it
    p = tmp_path / "uni.arpa"
    p.write_text(ARPA_UNIGRAM)
    table = torch.from_numpy(bigram_bias_from_arpa(str(p), V28, weight=0.2))
    r = teval.evaluate_batch(torch.from_numpy(_logits_for_text("a cab")),
                             ["a cab"], beam_width=8, lm_bias=table)
    assert r["wer"] == 0.0 and r["hyps"] == ["a cab"]
