"""The port's sampling against the JAX package on the same logits: greedy
rows are exact, and the repetition penalty, top-k and top-p masks are
exact.  The two frameworks' random streams differ, so sampled rows are
checked for staying inside the filtered support, not for the draw."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from githubrepostorag_tpu.ops import sampling as js
from githubrepostorag_tpu_torch.ops import sampling as ts


def _inputs(seed=0, b=4, v=64):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, v)).astype(np.float32) * 3
    presence = rng.random((b, v)) < 0.2
    return logits, presence


def test_penalty_and_masks_are_exact():
    logits, presence = _inputs()
    pen = np.asarray([1.0, 1.3, 0.8, 2.0], np.float32)
    t = ts.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(presence),
                                    torch.from_numpy(pen)[:, None])
    j = js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(presence),
                                    jnp.asarray(pen)[:, None])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    k = np.asarray([0, 1, 5, 64], np.int32)
    np.testing.assert_array_equal(ts.top_k_mask(torch.from_numpy(logits), torch.from_numpy(k)).numpy(),
                                  np.asarray(js.top_k_mask(jnp.asarray(logits), jnp.asarray(k))))
    p = np.asarray([1.0, 0.5, 0.9, 0.0], np.float32)
    np.testing.assert_array_equal(ts.top_p_mask(torch.from_numpy(logits), torch.from_numpy(p)).numpy(),
                                  np.asarray(js.top_p_mask(jnp.asarray(logits), jnp.asarray(p))))


def test_greedy_rows_are_exact_in_every_sampler():
    logits, presence = _inputs(1)
    b = logits.shape[0]
    temp = np.zeros(b, np.float32)
    top_p = np.full(b, 0.9, np.float32)
    top_k = np.asarray([0, 3, 0, 7], np.int32)
    pen = np.asarray([1.0, 1.2, 1.5, 1.0], np.float32)
    t_args = [torch.from_numpy(x) for x in (temp, top_p, top_k, pen, presence)]
    j_args = [jnp.asarray(x) for x in (temp, top_p, top_k, pen, presence)]
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    expect = np.asarray(js.sample_tokens(jl, key, *j_args))
    np.testing.assert_array_equal(ts.sample_tokens(tl, gen, *t_args).numpy(), expect)
    np.testing.assert_array_equal(ts.sample_tokens_capped(tl, gen, *t_args).numpy(),
                                  np.asarray(js.sample_tokens_capped(jl, key, *j_args)))
    np.testing.assert_array_equal(
        ts.sample_tokens_nofilter(tl, gen, t_args[0], t_args[3], t_args[4]).numpy(),
        np.asarray(js.sample_tokens_nofilter(jl, key, j_args[0], j_args[3], j_args[4])))


def test_sampled_rows_stay_in_the_filtered_support():
    logits, presence = _inputs(2, b=3, v=200)
    b = logits.shape[0]
    temp = np.full(b, 0.8, np.float32)
    top_p = np.asarray([0.5, 1.0, 0.9], np.float32)
    top_k = np.asarray([0, 4, 10], np.int32)
    pen = np.asarray([1.3, 1.0, 1.1], np.float32)
    # the support JAX's sampler draws from: penalised, scaled, filtered
    jl = js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(presence),
                                     jnp.asarray(pen)[:, None]) / jnp.asarray(temp)[:, None]
    support = np.asarray(js.top_p_mask(js.top_k_mask(jl, jnp.asarray(top_k)),
                                       jnp.asarray(top_p))) > -1e29
    gen = torch.Generator().manual_seed(1)
    args = [torch.from_numpy(x) for x in (temp, top_p, top_k, pen, presence)]
    for _ in range(50):
        for sampler in (ts.sample_tokens, ts.sample_tokens_capped):
            toks = sampler(torch.from_numpy(logits), gen, *args).numpy()
            assert support[np.arange(b), toks].all()
