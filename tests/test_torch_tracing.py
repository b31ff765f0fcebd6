"""The port's span and counter recorder (`utils/profiling.py`) and the spans
the program records with it, on the CPU at tiny sizes: nesting, counts and
the ring's bound; the recorder off; `record_function` only under a profiler;
beam search, the XE step and `generate_features` as they record; the weight
casts `linear` counts; and `deploy/aot.py`'s export left as it was."""
import dataclasses
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.api import Captioner
from on_device_image_captioning_torch.cli.generate_features import generate_features
from on_device_image_captioning_torch.decode import beam_search as bs
from on_device_image_captioning_torch.deploy import aot
from on_device_image_captioning_torch.models.common import linear
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2, init_weights
from on_device_image_captioning_torch.train import radam
from on_device_image_captioning_torch.train import train_step
from on_device_image_captioning_torch.utils import profiling

SWIN = pcfg.SwinConfig(img_size=32, patch_size=4, embed_dim=16, depths=(2, 2),
                       num_heads=(2, 4), window_size=4)
CAP = pcfg.CaptionerConfig(d_model=32, N_enc=1, N_dec=2, ff=64, num_heads=4,
                           num_exp_enc_list=(4,), num_exp_dec=4, vocab_size=50, max_seq_len=20,
                           img_feature_dim=SWIN.num_features, sos_idx=2, eos_idx=3, pad_idx=0,
                           unk_idx=1)
CFG = pcfg.ModelConfig(swin=SWIN, captioner=CAP)
L = 8


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Each test starts from an empty ring, recording on, no device events."""
    profiling.clear()
    profiling.set_tracing(True, device=False)
    yield
    profiling.set_tracing(True, device=False)


def _model(cfg=CFG, seed=0):
    return init_weights(EndExpansionNetV2(cfg), torch.Generator().manual_seed(seed)).eval()


def _images(b=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)


def _named(name):
    return [r for r in profiling.records() if r.name == name]


def test_spans_nest_and_count():
    with profiling.span("outer", k=1) as outer:
        profiling.count("c", 2)
        with profiling.span("inner") as inner:
            profiling.count("c", 3, nbytes=40)
        profiling.count("d")
    recs = profiling.records()
    assert [r.name for r in recs] == ["inner", "outer"]  # in the order they ended
    assert inner.parent == outer.id and outer.parent is None and inner.id != outer.id
    assert outer.attrs == {"k": 1} and inner.attrs is None
    assert inner.counts == {"c": 3, "c_bytes": 40}
    assert outer.counts == {"c": 5, "c_bytes": 40, "d": 1}  # its children's included
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.thread == outer.thread == threading.get_ident()
    assert not outer.profiled and outer.device_ms() is None


def test_threads_keep_their_own_stacks():
    def work():
        with profiling.span("other"):
            profiling.count("c")

    with profiling.span("main") as main:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    other = _named("other")[0]
    assert other.parent is None and other.thread != main.thread
    assert main.counts == {} and other.counts == {"c": 1}


def test_counts_from_many_threads_add_up():
    """Threads counting at once, switching as often as the interpreter
    allows, each keep every count in their own spans."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with profiling.span("worker"):
                for _ in range(2000):
                    profiling.count("c", 1, nbytes=2)

        threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    workers = _named("worker")
    assert len(workers) == len(threads)
    assert all(r.counts == {"c": 2000, "c_bytes": 4000} for r in workers)


def test_ring_keeps_the_last_capacity_records():
    n = profiling.CAPACITY + 5
    for i in range(n):
        with profiling.span("s", i=i):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.CAPACITY
    assert recs[0].attrs == {"i": 5} and recs[-1].attrs == {"i": n - 1}
    profiling.clear()
    assert profiling.records() == []


def test_off_records_nothing():
    profiling.set_tracing(False)
    assert not profiling.tracing()
    a, b = profiling.span("a"), profiling.span("b", t=1)
    assert a is b
    with a:
        profiling.count("c")
    assert profiling.records() == []
    profiling.set_tracing(True)
    with profiling.span("open") as open_:  # a count made while off reaches no span
        profiling.set_tracing(False)
        profiling.count("c")
        profiling.set_tracing(True)
    assert open_.counts == {}


def test_record_function_only_under_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counted(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    with profiling.span("bare"):
        pass
    assert entered == [] and not _named("bare")[0].profiled
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("seen"):
            torch.ones(4).sum()
    assert entered == ["odic.seen"] and _named("seen")[0].profiled
    assert any(e.name == "odic.seen" for e in prof.events())


def test_linear_counts_a_cast_only_where_the_dtype_changes():
    layer = torch.nn.Linear(8, 4)
    x = torch.randn(3, 8)
    with profiling.span("fp32") as same:
        linear(layer, x)
    with profiling.span("bf16") as cast:
        y = linear(layer, x, torch.bfloat16)
    no_bias = torch.nn.Linear(8, 4, bias=False)
    with profiling.span("no_bias") as weight_only:
        linear(no_bias, x, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert same.counts == {}
    assert cast.counts == {"weight_cast": 2, "weight_cast_bytes": (32 + 4) * 4}
    assert weight_only.counts == {"weight_cast": 1, "weight_cast_bytes": 32 * 4}


def _step_casts(model):
    """The weight casts of one bf16 decode step on the "pallas_fused" path:
    two a linear with a bias (weight and bias), one without; Wq and
    out_linear are laid out once and not cast a step."""
    def casts(layer):
        return 1 + (layer.bias is not None)

    n = sum(casts(l) for l in (model.dec_reduce_group, model.vocab_linear))
    for layer in model.decoders:
        p = layer.dyn_exp
        n += sum(casts(l) for l in (p.cond_embed, p.key_linear, p.class_a_embed,
                                    p.class_b_embed, p.selector_embed,
                                    layer.ff.linear_1, layer.ff.linear_2))
    return n


def test_beam_search_records_and_is_unchanged_by_recording():
    cfg = dataclasses.replace(CFG, compute_dtype=torch.bfloat16)
    cap = Captioner(_model(cfg), cfg, {"beam_size": 3, "beam_max_seq_len": L},
                    device="cpu", step_impl="pallas_fused")
    images = _images()
    results = []
    for on in (True, False):
        profiling.set_tracing(on)
        profiling.clear()
        res = cap.decode(cap.forward_enc(images))
        results.append(res)
        bs.captions_from_result(res)
        if on:
            recorded = profiling.records()
    a, b = results
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
    assert torch.equal(a.logprobs, b.logprobs)
    assert profiling.records() == []  # the run with recording off

    names = [r.name for r in recorded]
    assert names.count("encode") == names.count("decode") == names.count("decode.start") == 1
    decode = next(r for r in recorded if r.name == "decode")
    steps = [r for r in recorded if r.name == "decode.step"]
    syncs = [r for r in recorded if r.name == "decode.sync"]
    assert all(r.parent == decode.id for r in steps + syncs)
    # one sync an exit test: before every step, and the one that stopped the loop
    assert [r.attrs["t"] for r in steps] == list(range(2, 2 + len(steps)))
    stopped_early = len(steps) < L - 2
    assert [r.attrs["t"] for r in syncs] == list(range(2, 2 + len(steps) + stopped_early))
    assert decode.counts["weight_cast"] == _step_casts(cap.model) * (1 + len(steps))
    assert names[-1] == "captions"


def test_trace_holds_the_decode_spans(tmp_path):
    cap = Captioner(_model(), CFG, {"beam_size": 2, "beam_max_seq_len": 4}, device="cpu")
    with profiling.trace(str(tmp_path / "tb")):
        cap.beam_search(_images())
    files = [f for f in os.listdir(tmp_path / "tb") if f.endswith(".json")]
    events = json.loads((tmp_path / "tb" / files[0]).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"odic.encode", "odic.decode", "odic.decode.step", "odic.decode.sync",
            "odic.captions"} <= names
    assert all(r.profiled for r in profiling.records())


def test_xe_step_records_its_parts_in_order():
    model = _model().train()
    step = train_step.make_xe_step(model, CFG, radam.PlainRAdam(model.parameters(), 1e-3))
    captions = torch.tensor([[2, 5, 6, 7, 3, 0], [2, 8, 9, 3, 0, 0]])
    step({"enc_input": torch.from_numpy(_images()), "captions": captions})
    recs = profiling.records()
    root = _named("xe")[0]
    parts = [r for r in recs if r.name.startswith("xe.")]
    assert [r.name for r in parts] == ["xe.forward", "xe.backward", "xe.optimizer"]
    assert all(r.parent == root.id for r in parts)
    assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
    assert sum(r.ms for r in parts) <= root.ms


class _Store:
    def __init__(self):
        self.rows = {}

    def write(self, img_id, features):
        self.rows[img_id] = features


def test_generate_features_records_four_spans_a_batch():
    backbone = _model().swin_transf
    records = [{"img_id": i, "img_path": str(i)} for i in range(5)]
    store = _Store()

    def load(paths, size):
        return _images(len(paths), int(paths[0]))

    done = generate_features(backbone, records, store, 2, torch.float32, np.float32, load,
                             verbose=False)
    assert done == 5 and sorted(store.rows) == list(range(5))
    names = [r.name for r in profiling.records()]
    for part in ("wait", "backbone", "fetch", "store"):
        assert names.count("features." + part) == 3, names


def test_export_is_unchanged_by_recording():
    """The exported graph is the same node for node with recording on and
    off, and the export recorded nothing."""
    cfg = dataclasses.replace(CFG, captioner=dataclasses.replace(CAP, N_dec=1))
    model = _model(cfg)
    dcfg = pcfg.DecodeConfig(beam_size=2, how_many_outputs=1, max_seq_len=4, sos_idx=2,
                             eos_idx=3)
    graphs = []
    for on in (True, False):
        profiling.set_tracing(on)
        ep = aot._export(model, cfg, dcfg, 1, False, "pallas", None)
        graphs.append([(n.op, str(n.target)) for n in ep.graph.nodes])
    assert graphs[0] == graphs[1]
    assert profiling.records() == []
