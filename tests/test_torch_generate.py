"""The port's generation loops (models/generate.py) and host-side
samplers (models/sampling.sample, sample_np) against the reference's.

- ``generate`` and ``generate_scan`` greedy: token for token the
  reference's on quote weights (llama ``tiny``, int8 weights, bf16
  activations; the quote head leaves no near-ties), and mixtral
  ``tiny-moe`` through the same loop equal to its own dense steps;
- ``sample_np``: bitwise the reference's for the same
  ``np.random.Generator`` seed over a grid of options;
- ``sample``: its warped distribution (temperature, top-k, top-p) within
  1e-6 of the reference's (threefry keys cannot match token for token),
  every draw inside the kept set, greedy at temperature 0, and the same
  draws again from a generator seeded alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2p_llm_chat_tpu.models import generate as ref_generate
from p2p_llm_chat_tpu.models import sampling as ref_sampling
from p2p_llm_chat_tpu.models.configs import get_config as ref_config
from p2p_llm_chat_tpu.models.synth import quote_params
from p2p_llm_chat_tpu_torch.models import family_for
from p2p_llm_chat_tpu_torch.models import generate as gen
from p2p_llm_chat_tpu_torch.models import sampling
from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(2)
pytestmark = pytest.mark.model

PROMPT = [1, 72, 101, 108, 108, 111, 44, 32, 48, 49, 50]


def _pair(config: str):
    params = quote_params(ref_config(config), jax.random.PRNGKey(11),
                          quantized=True)
    cfg = get_config(config)
    ported = family_for(cfg).fuse_params(params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"))
    return params, ported, cfg


def test_generate_greedy_equals_reference():
    """llama ``tiny`` (the reference's generate loops run llama's
    functions only)."""
    config = "tiny"
    params, ported, cfg = _pair(config)
    want = ref_generate.generate(params, ref_config(config),
                                 jnp.asarray(PROMPT, jnp.int32),
                                 max_new_tokens=24)
    seen = []
    got = gen.generate(ported, cfg, torch.tensor(PROMPT), max_new_tokens=24,
                       on_token=seen.append)
    assert got == want and seen == got and len(got) > 0
    scan_want = np.asarray(ref_generate.generate_scan(
        params, ref_config(config), jnp.asarray(PROMPT, jnp.int32), 24))
    scan = gen.generate_scan(ported, cfg, torch.tensor(PROMPT), 24)
    np.testing.assert_array_equal(scan.numpy(), scan_want)


def test_generate_runs_the_moe_family():
    """models/generate.py follows the config's family: mixtral's greedy
    stream equals its own dense decode_step loop."""
    _, ported, cfg = _pair("tiny-moe")
    got = gen.generate(ported, cfg, torch.tensor(PROMPT), max_new_tokens=12)
    fam = family_for(cfg)
    cache = fam.KVCache.create(cfg, 1, 64, dtype=torch.bfloat16,
                               device="cpu")
    logits, cache = fam.prefill(ported, cfg, torch.tensor([PROMPT]),
                                torch.tensor([len(PROMPT)]), last_only=True,
                                cache=cache)
    want = []
    tok = logits[:, 0].argmax(-1)
    while len(want) < 12 and int(tok) not in cfg.eos_token_ids:
        want.append(int(tok))
        logits, cache = fam.decode_step(ported, cfg, tok[:, None], cache)
        tok = logits[:, 0].argmax(-1)
    assert got == want


OPTIONS = [dict(temperature=0.0), dict(temperature=0.7),
           dict(temperature=1.0, top_k=5), dict(temperature=0.9, top_p=0.8),
           dict(temperature=1.3, top_k=40, top_p=0.5),
           dict(temperature=0.8, top_p=0.0),
           dict(temperature=1.0, recent=[3, 4, 9], repeat_penalty=1.3)]


@pytest.mark.parametrize("opts", OPTIONS)
def test_sample_np_is_the_reference_bitwise(opts):
    logits = np.random.default_rng(2).standard_normal((512,)) * 3
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    got = [sampling.sample_np(logits, r1, **opts) for _ in range(64)]
    want = [ref_sampling.sample_np(logits, r2, **opts) for _ in range(64)]
    assert got == want


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.7, 0, 1.0), (1.0, 5, 1.0), (0.9, 0, 0.8), (1.3, 40, 0.5),
    (0.8, 0, 0.0)])
def test_sample_distribution_matches_reference(temperature, top_k, top_p):
    logits = (np.random.default_rng(3).standard_normal((4, 512)) * 3
              ).astype(np.float32)
    lt = torch.from_numpy(logits)
    got = torch.softmax(sampling.warp(lt, temperature, top_k, top_p),
                        dim=-1).numpy()
    x = jnp.asarray(logits) / temperature
    x = ref_sampling._apply_top_p(ref_sampling._apply_top_k(x, top_k),
                                  top_p)
    want = np.asarray(jax.nn.softmax(x, axis=-1))
    np.testing.assert_allclose(got, want, atol=1e-6)
    g1 = torch.Generator().manual_seed(5)
    draws = torch.stack([sampling.sample(lt, g1, temperature, top_k, top_p)
                         for _ in range(200)])
    kept = torch.from_numpy(want > 0)
    assert kept.gather(1, draws.T).all()
    g2 = torch.Generator().manual_seed(5)
    again = torch.stack([sampling.sample(lt, g2, temperature, top_k, top_p)
                         for _ in range(200)])
    assert torch.equal(draws, again)
    assert torch.equal(sampling.sample(lt, g1, 0.0), lt.argmax(-1))
