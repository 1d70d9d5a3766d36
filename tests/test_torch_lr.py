"""Port parity of the LR schedulers (``paddle_tpu_torch.optimizer.lr``)
against the JAX package's: every scheduler's learning rate over 40 steps,
and over 20 more after its state dict was copied into a fresh scheduler,
equal to JAX's to 1e-12 relative."""
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

CASES = {
    "ConstantLR": lambda m: m.ConstantLR(0.1, factor=0.5, total_iters=7),
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 15, 30],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=25,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay-cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=9, end_lr=0.001, cycle=True),
    "LinearWarmup-float": lambda m: m.LinearWarmup(0.1, warmup_steps=8,
                                                   start_lr=0.0, end_lr=0.1),
    "LinearWarmup-sched": lambda m: m.LinearWarmup(
        m.PolynomialDecay(1e-4, decay_steps=30), warmup_steps=5,
        start_lr=0.0, end_lr=1e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.93),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [6, 19, 33], 0.3),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.97 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.95),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        0.1, factor=0.5, patience=2, cooldown=1, min_lr=1e-4),
    "ReduceOnPlateau-max-abs": lambda m: m.ReduceOnPlateau(
        0.1, mode="max", threshold_mode="abs", threshold=0.01, patience=1),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=17, eta_min=1e-3),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=35),
    "OneCycleLR-linear": lambda m: m.OneCycleLR(
        0.1, total_steps=35, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=6,
                                     step_size_down=4),
    "CyclicLR-triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="triangular2"),
    "CyclicLR-exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.98),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2, eta_min=1e-3),
    "CosineAnnealingWarmRestarts-T1": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=6),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=23, start_factor=0.2),
}


def _metric(i):
    """A plateauing, noisy loss for ReduceOnPlateau."""
    return 1.0 / (1 + i) + 0.3 * math.sin(i) ** 2


def _advance(s, lo, hi):
    out = []
    for i in range(lo, hi):
        if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            s.step(_metric(i))
        else:
            s.step()
        out.append(s())
    return out


def _close(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert abs(x - y) <= 1e-12 * max(abs(x), 1e-30), (i, x, y)


@pytest.mark.parametrize("name", sorted(CASES))
def test_scheduler_matches_jax(name):
    """40 steps from construction, then the state dict into a fresh
    scheduler of each package and 20 steps more."""
    make = CASES[name]
    j, t = make(jlr), make(tlr)
    _close([t()], [j()])
    _close(_advance(t, 0, 40), _advance(j, 0, 40))
    j2, t2 = make(jlr), make(tlr)
    j2.set_state_dict(dict(j.state_dict()))
    t2.set_state_dict(dict(t.state_dict()))
    assert t.state_dict().keys() == j.state_dict().keys()
    _close(_advance(t2, 40, 60), _advance(j2, 40, 60))
    _close(_advance(t, 40, 60), _advance(j, 40, 60))
