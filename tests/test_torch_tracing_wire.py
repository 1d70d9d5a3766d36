"""Port parity: the Tracer's cross-process wire form
(``paddle_tpu_torch.observability.tracing.tracer_to_wire`` /
``tracer_from_wire``), which a fleet worker ships over its ``trace`` RPC.
The same recorded events give the same JSON as the JAX package's
``tracer_to_wire``, attribute values that are numpy scalars (JAX) or
one-element tensors (the port) included, and a rebuilt Tracer gives back
the same wire form and the same Chrome trace."""
import json

import numpy as np
import torch

from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch.observability import tracing as ttracing


def _record(mod, scalar):
    """A tracer of ``mod`` holding a finished and a live request, engine
    spans and instants, and two counter samples; ``scalar`` makes each
    numeric attribute of the package's own kind."""
    tr = mod.Tracer(clock=lambda: 100.0)
    tr.request_event(0, "submitted", t=1.0, prompt_tokens=scalar(7),
                     trace_id=12)
    tr.request_event(0, "admitted", t=1.5, replica="w0")
    tr.request_event(0, "first_token", t=2.25)
    tr.request_event(0, "retired", t=3.0, tokens=scalar(12), migrations=0)
    tr.request_event(1, "submitted", t=1.25, prompt_tokens=scalar(5))
    tr.request_event(1, "preempted", t=2.5, kind="migrate")
    tr.engine_span("decode", 1.5, 2.0, horizon=scalar(4), greedy=True)
    tr.engine_event("spawn", t=0.5, worker="w1", generation=1)
    tr.engine_event("mark")                    # the tracer's own clock
    tr.counter("pool", t=2.0, free=scalar(30), used=10)
    tr.counter("pool", t=2.5, free=28.5, used=scalar(11))
    return tr


def test_wire_form_matches_jax_and_round_trips():
    jwire = jtracing.tracer_to_wire(_record(jtracing, np.int64))
    twire = ttracing.tracer_to_wire(_record(ttracing, torch.tensor))
    assert json.dumps(twire, sort_keys=True) \
        == json.dumps(jwire, sort_keys=True)
    # every attribute became a plain Python number
    assert twire["requests"][0]["events"][0][2]["prompt_tokens"] == 7
    assert type(twire["engine"][0][3]["horizon"]) is int
    back = ttracing.tracer_from_wire(json.loads(json.dumps(twire)))
    assert ttracing.tracer_to_wire(back) == twire
    assert [t.rid for t in back.traces()] == [0, 1]
    assert back.get(1) is not None and back.get(0).names()[-1] == "retired"
    assert back.counter_events() == _record(
        ttracing, float).counter_events()
    assert back.to_chrome_trace() \
        == ttracing.tracer_from_wire(jwire).to_chrome_trace()


def test_attributes_that_are_not_scalars_travel_as_text():
    """An attribute that no ``item()`` turns into a number (a
    multi-element tensor or array) travels as its text, as JAX's does for
    an array."""
    tr = ttracing.Tracer(clock=lambda: 0.0)
    tr.request_event(3, "submitted", t=0.0, shape=torch.tensor([2, 3]))
    jt = jtracing.Tracer(clock=lambda: 0.0)
    jt.request_event(3, "submitted", t=0.0, shape=np.array([2, 3]))
    got = ttracing.tracer_to_wire(tr)["requests"][0]["events"][0][2]
    want = jtracing.tracer_to_wire(jt)["requests"][0]["events"][0][2]
    assert got == {"shape": str(torch.tensor([2, 3]))}
    assert want == {"shape": str(np.array([2, 3]))}
