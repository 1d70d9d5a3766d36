"""Port parity of the quantized serving plane's parity harness
(``serving.quant``) against the JAX package's: ``parity_scenarios`` array
for array, and on a tiny LLaMA ``parity_report`` with int8 pages and
8-bit weights — the same ``exact_match``, ``token_match`` and mismatched
requests, and ``max_logit_drift`` within 1e-5 of JAX's."""
import numpy as np
import pytest

from test_torch_serving import (_jax_plain_dispatch, _models,  # noqa: F401
                                _port_engines_stay_consistent)
from paddle_tpu.serving import quant as jquant
from paddle_tpu_torch.serving import quant as tquant


@pytest.mark.parametrize("page_size,seed", [(8, 0), (4, 3)])
def test_parity_scenarios_match_jax(page_size, seed):
    j = jquant.parity_scenarios(256, seed=seed, page_size=page_size)
    t = tquant.parity_scenarios(256, seed=seed, page_size=page_size)
    assert len(t) == len(j) == 8
    for (tp, tm), (jp, jm) in zip(t, j):
        assert tm == jm and tp.dtype == jp.dtype
        np.testing.assert_array_equal(tp, jp)


def test_parity_report_matches_jax():
    jp, tp, jcfg, tcfg = _models(4)
    kw = dict(kv_dtype="int8", quantize=8, drift_prompts=1, drift_steps=3,
              engine_kw=dict(page_size=4, prompt_bucket=8,
                             decode_horizon=2))
    scen = jquant.parity_scenarios(jcfg.vocab_size, page_size=4)[:2]
    jrep = jquant.parity_report(jp, jcfg, scenarios=scen, **kw)
    kw["engine_kw"] = dict(kw["engine_kw"], device="cpu")
    trep = tquant.parity_report(tp, tcfg, scenarios=scen, **kw)
    for k in ("kv_dtype", "weight_bits", "scenarios", "exact_match",
              "token_match", "mismatched"):
        assert trep[k] == jrep[k], k
    assert 0.0 <= trep["exact_match"] <= 1.0
    assert trep["max_logit_drift"] > 0.0        # quantization is lossy
    assert abs(trep["max_logit_drift"] - jrep["max_logit_drift"]) <= 1e-5
