"""The beam search replayed from CUDA graphs (`decode/graphs.py`,
`decode/beam_search.py::_graphed_beam_search`).

On the CPU, at tiny sizes: which calls engage the graphs and which take the
eager loop; what keys a decode's graphs (a new key, or moved weights, warm
up and capture anew); the cache's bound; the counters (a replay adds back
what its capture counted); results that never alias the graphs' outputs;
and the graphed loop, on `graphs.HostGraph` (a replay runs the step again
and copies its outputs into the captured ones), equal to the eager loop bit
for bit: fp32 and bf16, both step paths, captions that end early, pads, an
ensemble. Marked `cuda` (skipped without a card): the same on CUDA graphs at
the serving cell's shape and at b1 / beam 5 / L74, with early ends, a held
result, a weight update and a larger eager decode between replays."""
import dataclasses
import threading
import types

import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.decode import beam_search as bs
from on_device_image_captioning_torch.decode import graphs
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.deploy.quantization import quantize_decoder
from on_device_image_captioning_torch.ops import dyn_exp_step, topk
from on_device_image_captioning_torch.utils import profiling

CAP = pcfg.CaptionerConfig(d_model=32, N_enc=1, N_dec=2, ff=64, num_heads=4,
                           num_exp_enc_list=(4,), num_exp_dec=4, vocab_size=50, max_seq_len=20,
                           img_feature_dim=24, sos_idx=2, eos_idx=3, pad_idx=0, unk_idx=1)
DCFG = pcfg.DecodeConfig(beam_size=3, how_many_outputs=2, max_seq_len=16, sos_idx=2, eos_idx=3)
S_ENC = 7


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.clear()
    profiling.set_tracing(True, device=False)
    yield
    profiling.set_tracing(True, device=False)


def _model(cfg=CAP, seed=0, device="cpu"):
    torch.manual_seed(seed)
    with torch.device(device):
        return ExpansionNetV2(cfg).eval()


def _no_eos(model):
    """EOS never emitted: every caption runs to max_seq_len."""
    with torch.no_grad():
        model.vocab_linear.bias[model.cap_cfg.eos_idx] = -1e4
    return model


def _ends_early(model, start=2, slope=1.0, beta=2.0):
    """EOS favoured more at each step after `start`: the position
    embedding's first channel grows by `slope` a step from there, and the
    output linear reads it into EOS's logit with weight `beta`."""
    with torch.no_grad():
        pos = model.pos_encoder.weight
        steps = torch.arange(pos.shape[0], device=pos.device, dtype=pos.dtype) - start
        pos[:, 0] += slope * steps.clamp_min(0)
        model.vocab_linear.weight[model.cap_cfg.eos_idx, 0] += beta
    return model


def _enc(rows=3, seed=1, s=S_ENC, d=32, device="cpu"):
    return torch.randn((rows, s, d), generator=torch.Generator().manual_seed(seed)).to(device)


def _equal(a: bs.BeamResult, b: bs.BeamResult) -> bool:
    return all(torch.equal(x, y) for x, y in zip(graphs.tensors(a), graphs.tensors(b)))


def _graphed(models, encs, dcfg=DCFG, dtype=None, pads=None, step_impl="pallas", cache=None,
             graphs_for=graphs.host_graphs):
    """One graphed call, inside a `decode` span as `ensemble_beam_search`
    opens it: (result, the span's counts)."""
    with torch.no_grad(), profiling.span("decode") as sp:
        res = bs._graphed_beam_search(models, CAP, encs, dcfg, dtype, pads, step_impl,
                                      cache=cache, graphs_for=graphs_for)
    return res, sp.counts


def _eager(models, encs, dcfg=DCFG, dtype=None, pads=None, step_impl="pallas"):
    with torch.no_grad():
        return bs._eager_beam_search(models, CAP, encs, dcfg, dtype, pads, step_impl)


# -- when the graphs engage -----------------------------------------------------

_ON_CARD = types.SimpleNamespace(is_cuda=True)  # an encoder output as the rule sees it
NOT_ENGAGING = {
    "cpu_tensors": dict(enc=torch.zeros(1)),
    "sample": dict(dcfg=dataclasses.replace(DCFG, sample_or_max="sample")),
    "generator": dict(generator=torch.Generator()),
    "noise": dict(noise=[torch.zeros(1)]),
    "gradients_on": dict(grad=True),
    "compiling": dict(compiling=True),
    "model_axis_cut": dict(cut=True),
}


@pytest.mark.parametrize("case", ["engages", *NOT_ENGAGING])
def test_engagement_rule(case, monkeypatch):
    """CUDA encoder outputs, "max", no generator or noise, gradients off,
    outside a trace and no model cut over a model axis engage the graphs;
    each departure from that does not."""
    a = NOT_ENGAGING.get(case, {})
    model = types.SimpleNamespace()
    if a.get("cut"):
        model.model_axis_cuts = {"vocab_linear": object()}
    if a.get("compiling"):
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with torch.set_grad_enabled(a.get("grad", False)):
        on = graphs.engages([model], [a.get("enc", _ON_CARD)], a.get("dcfg", DCFG),
                            a.get("generator"), a.get("noise"))
    assert on == (case == "engages")


@pytest.mark.parametrize("engaged", [False, True])
def test_ensemble_beam_search_takes_the_path_the_rule_picks(engaged, monkeypatch):
    """`ensemble_beam_search` calls the graphed loop where the rule engages
    and the eager loop elsewhere, inside its `decode` span."""
    called = []
    monkeypatch.setattr(graphs, "engages", lambda *a: engaged)
    monkeypatch.setattr(bs, "_graphed_beam_search", lambda *a: called.append("graphed"))
    monkeypatch.setattr(bs, "_eager_beam_search", lambda *a: called.append("eager"))
    bs.ensemble_beam_search([_model()], CAP, [_enc()], DCFG)
    assert called == ["graphed" if engaged else "eager"]
    assert [r.name for r in profiling.records()] == ["decode"]


def test_cpu_calls_run_eagerly():
    """On the CPU the public loop never captures: no graph counter, and the
    eager loop's result."""
    model, enc = _model(), _enc()
    with profiling.span("outer") as sp:
        got = bs.ensemble_beam_search([model], CAP, [enc], DCFG)
    assert _equal(got, _eager([model], [enc]))
    assert "decode_graph_capture" not in sp.counts and "decode_graph_replay" not in sp.counts


# -- the key ----------------------------------------------------------------------

def _key(models=None, encs=None, dcfg=DCFG, dtype=None, pads=None, step_impl="pallas"):
    models = models if models is not None else [_MODEL]
    encs = encs if encs is not None else [_enc()]
    return graphs.decode_key(models, encs, dcfg, bs.schedule_of(dcfg), dtype, pads, step_impl)


_MODEL = _model()
KEY_CHANGES = {
    "rows": dict(encs=[_enc(rows=4)]),
    "s_enc": dict(encs=[_enc(s=9)]),
    "beam": dict(dcfg=dataclasses.replace(DCFG, beam_size=2)),
    "max_seq_len": dict(dcfg=dataclasses.replace(DCFG, max_seq_len=15)),
    "schedule": dict(dcfg=dataclasses.replace(DCFG, chunk_schedule=(8, 16))),
    "outputs": dict(dcfg=dataclasses.replace(DCFG, how_many_outputs=1)),
    "dtype": dict(dtype=torch.bfloat16),
    "step_impl": dict(step_impl="pallas_fused"),
    "pads": dict(pads=torch.zeros(3, dtype=torch.int64)),
    "model": dict(models=[_model(seed=1)]),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_key_changes_with_what_the_graphs_bake_in(change):
    assert _key(**KEY_CHANGES[change]) != _key()
    assert _key() == _key()  # equal inputs: one key


def test_default_schedule_is_the_same_key():
    """An unset schedule and the default one it stands for run the same
    graphs."""
    spelled = dataclasses.replace(DCFG, chunk_schedule=bs.default_chunk_schedule(16))
    assert _key(dcfg=spelled) == _key()


def test_inference_mode_is_part_of_the_key():
    plain = _key()
    with torch.inference_mode():
        assert _key() != plain


def test_each_thread_has_its_own_key():
    """Two threads never replay one decode's fixed buffers."""
    keys = [_key()]
    worker = threading.Thread(target=lambda: keys.append(_key()))
    worker.start()
    worker.join()
    assert keys[0] != keys[1]


def _moved_weight(model):
    """The output linear's bias replaced by a new tensor of the same values."""
    model.vocab_linear.bias = torch.nn.Parameter(model.vocab_linear.bias.detach().clone())


def _updated_weight(model):
    """The output linear's bias updated in place (its version moves)."""
    with torch.no_grad():
        model.vocab_linear.bias.add_(0.25)


@pytest.mark.parametrize("update", [_moved_weight, _updated_weight], ids=["moved", "in_place"])
def test_weights_that_move_warm_up_and_capture_anew(update):
    """Warm-up, capture, replay; then a moved or updated decoder weight
    drops the graphs: the next call warms up eagerly, the one after
    captures again, and each equals the eager loop on the new weights."""
    model, enc, cache = _model(), _enc(), graphs.DecodeCache()
    for _ in range(3):
        _graphed([model], [enc], cache=cache)
    state = graphs.weights_state([model])
    update(model)
    assert graphs.weights_state([model]) != state
    want = _eager([model], [enc])
    seen = [_graphed([model], [enc], cache=cache) for _ in range(3)]
    assert all(_equal(res, want) for res, _ in seen)
    counts = [c for _, c in seen]
    assert "decode_graph_replay" not in counts[0]  # warm-up
    assert counts[1]["decode_graph_capture"] == counts[1]["decode_graph_replay"] == DCFG.max_seq_len
    assert "decode_graph_capture" not in counts[2]


def test_encoder_side_weights_are_not_in_the_weights_state():
    """Only what the decode reads keys its graphs."""
    model = _model()
    state = graphs.weights_state([model])
    with torch.no_grad():
        model.input_linear.weight.add_(1.0)
    assert graphs.weights_state([model]) == state


def test_a_new_model_at_the_same_key_does_not_replay():
    """An entry whose model is gone warms up again (no replay of graphs of
    a model that no longer exists)."""
    cache, enc = graphs.DecodeCache(), _enc()
    model = _model()
    for _ in range(2):
        _graphed([model], [enc], cache=cache)
    key = next(iter(cache.entries))
    entry = cache.entries[key]
    entry.models = (lambda: None,)  # as a weak reference to a model since freed
    assert cache.lookup(key, [model]) is None and key not in cache.entries


# -- the cache ------------------------------------------------------------------

def test_cache_keeps_its_capacity_least_recently_used_first():
    cache = graphs.DecodeCache(capacity=2)
    model = _model()
    for k in ("a", "b"):
        cache.warmed(k, [model])
    assert cache.lookup("a", [model]) is not None  # "a" is now the most recent
    cache.warmed("c", [model])
    assert list(cache.entries) == ["a", "c"]
    assert cache.lookup("b", [model]) is None


def test_a_key_seen_once_holds_no_graph():
    """Evaluation's one smaller last batch: warmed, never captured."""
    model, cache = _model(), graphs.DecodeCache()
    _graphed([model], [_enc(rows=3)], cache=cache)
    _graphed([model], [_enc(rows=3)], cache=cache)
    _graphed([model], [_enc(rows=2)], cache=cache)
    held = {k[1][0][0][0]: e.decode is not None for k, e in cache.entries.items()}
    assert held == {3: True, 2: False}


def test_process_cache_is_bounded():
    assert bs._GRAPHS.capacity == graphs.CAPACITY <= 8


# -- the graphed loop against the eager loop --------------------------------------

LOOPS = {
    "fp32_pallas": dict(dtype=None, step_impl="pallas"),
    "bf16_fused": dict(dtype=torch.bfloat16, step_impl="pallas_fused"),
    "bf16_pallas": dict(dtype=torch.bfloat16, step_impl="pallas"),
}


@pytest.mark.parametrize("early", [False, True], ids=["runs_to_L", "ends_early"])
@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_graphed_loop_equals_eager(loop, early):
    """Warm-up, capture and two replays (the second on another encoder
    output) each equal the eager loop bit for bit; with EOS favoured the
    captions end at different steps and the loop stops early."""
    a = LOOPS[loop]
    model = _ends_early(_model()) if early else _no_eos(_model())
    cache = graphs.DecodeCache()
    for seed in (1, 1, 1, 2):
        enc = _enc(seed=seed)
        want = _eager([model], [enc], **a)
        got, counts = _graphed([model], [enc], cache=cache, **a)
        assert _equal(got, want)
    lengths = want.lengths.flatten().tolist()
    if early:
        assert max(lengths) < DCFG.max_seq_len and len(set(lengths)) > 1
        assert counts["decode_graph_replay"] < DCFG.max_seq_len  # fewer steps replayed
    else:
        assert set(lengths) == {DCFG.max_seq_len}
        assert counts["decode_graph_replay"] == DCFG.max_seq_len  # start, 14 steps, ranking


def test_graphed_ensemble_with_pads_equals_eager():
    """Two models over padded feature rows (their encoder pad mask a static
    input of the start's graph)."""
    models = [_ends_early(_model(seed=0)), _model(seed=3)]
    cache = graphs.DecodeCache()
    for seed, pads in ((1, [0, 2, 5]), (1, [0, 2, 5]), (2, [1, 0, 3])):
        encs = [_enc(seed=seed), _enc(seed=seed + 10)]
        p = torch.tensor(pads)
        got, _ = _graphed(models, encs, pads=p, cache=cache)
        assert _equal(got, _eager(models, encs, pads=p))


def test_replays_add_back_what_the_capture_counted():
    """The weight casts a bf16 step makes are counted at every replay as in
    the eager loop (the capture's own counts are set aside), one
    `decode_graph_replay` a step run, and `decode_graph_capture` once a step
    captured."""
    model, enc, cache = _model(), _enc(), graphs.DecodeCache()
    a = LOOPS["bf16_fused"]
    with profiling.span("decode") as eager:
        _eager([model], [enc], **a)
    seen = [_graphed([model], [enc], cache=cache, **a)[1] for _ in range(3)]
    casts = {k: v for k, v in eager.counts.items() if k.startswith("weight_cast")}
    assert casts["weight_cast"] > 0
    for counts in seen:
        assert {k: v for k, v in counts.items() if k.startswith("weight_cast")} == casts
    assert seen[1]["decode_graph_capture"] == DCFG.max_seq_len
    assert [c.get("decode_graph_replay", 0) for c in seen] == [0] + [DCFG.max_seq_len] * 2


def test_replays_add_back_the_kernel_launch_counters():
    """The kernels' launch counters count a captured step's launches at
    each replay, not at its capture (which launches nothing)."""
    start = topk.launches

    def step():
        topk.launches += 3
        return torch.zeros(1)

    graph = graphs.HostGraph()
    graph.capture(step)
    assert topk.launches == start
    graph.replay()
    graph.replay()
    assert topk.launches == start + 6
    topk.launches = start


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_graphed_quantized_decoder_equals_eager(mode):
    """A decoder of int8 linears (the "pallas" step where Wq is quantized)
    replays as it runs eagerly."""
    model = quantize_decoder(_ends_early(_model()), mode)
    a = LOOPS["bf16_fused"]
    cache = graphs.DecodeCache()
    for _ in range(3):
        got, counts = _graphed([model], [_enc()], cache=cache, **a)
        assert _equal(got, _eager([model], [_enc()], **a))
    assert counts["decode_graph_replay"] > 2


def test_set_aside_keeps_counts_from_spans():
    with profiling.span("outer") as outer:
        with profiling.set_aside() as aside:
            profiling.count("c", 2, nbytes=8)
            with profiling.span("inner") as inner:
                profiling.count("c")
        profiling.count("d")
    assert aside == {"c": 3, "c_bytes": 8}
    assert inner.counts == {"c": 1} and outer.counts == {"d": 1}


def test_results_never_alias_the_graphs_outputs():
    """A result is a copy: it shares no storage with any captured tensor,
    and a later replay on other inputs leaves a held result as it was."""
    model, cache = _model(), graphs.DecodeCache()
    for _ in range(2):
        held, _ = _graphed([model], [_enc(seed=1)], cache=cache)
    kept = [t.clone() for t in graphs.tensors(held)]
    dec = next(iter(cache.entries.values())).decode
    captured = {t.untyped_storage().data_ptr()
                for t in graphs.tensors((dec.enc, dec.beams, dec.result, dec.held[0]))}
    assert not captured & {t.untyped_storage().data_ptr() for t in graphs.tensors(held)}
    other, _ = _graphed([model], [_enc(seed=2)], cache=cache)
    assert not _equal(other, held)
    assert all(torch.equal(a, b) for a, b in zip(kept, graphs.tensors(held)))


def test_a_capture_that_lays_out_is_thrown_away(monkeypatch):
    """Where the fused step's operands are no longer laid out when the
    capture comes (another dtype laid them out since), the capture is
    dropped, what it laid out is put back as it was, and the call runs
    eagerly; the next call captures."""
    model, enc, cache = _model(), _enc(), graphs.DecodeCache()
    a = LOOPS["bf16_fused"]
    _graphed([model], [enc], cache=cache, **a)
    for layer in model.decoders:
        del layer._cross_operands
    restored = []
    restore = graphs.restore_lazy_state
    monkeypatch.setattr(graphs, "restore_lazy_state",
                        lambda m, d, state: restored.append(state[2:]) or restore(m, d, state))
    res, counts = _graphed([model], [enc], cache=cache, **a)
    assert restored == [(None,) * len(model.decoders)]
    assert _equal(res, _eager([model], [enc], **a))
    assert "decode_graph_replay" not in counts
    assert next(iter(cache.entries.values())).decode is None
    res, counts = _graphed([model], [enc], cache=cache, **a)
    assert counts["decode_graph_replay"] == DCFG.max_seq_len
    assert _equal(res, _eager([model], [enc], **a))


def test_lazy_state_restore_puts_back_workspaces_and_layouts():
    model = _model()
    dev = torch.device("cpu")
    before = graphs.lazy_state([model], dev)
    dyn_exp_step._workspace[dev] = (torch.zeros(1), torch.zeros(1))
    model.decoders[0]._cross_operands = ("key", ())
    assert not graphs.same_lazy_state(before, graphs.lazy_state([model], dev))
    graphs.restore_lazy_state([model], dev, before)
    assert graphs.same_lazy_state(before, graphs.lazy_state([model], dev))
    assert dev not in dyn_exp_step._workspace


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FULL = pcfg.expansionnet_v2_coco()
CARD_CASES = {  # rows, beam, max_seq_len, step path: the serving cell and a five-phase decode
    "b32_beam3_L20_fused": (32, 3, 20, "pallas_fused"),
    "b1_beam5_L74_pallas": (1, 5, 74, "pallas"),
}


def _card_inputs(cuda, case, seed=0):
    rows, beam, L, impl = CARD_CASES[case]
    dcfg = pcfg.DecodeConfig(beam_size=beam, how_many_outputs=1, max_seq_len=L,
                             sos_idx=FULL.sos_idx, eos_idx=FULL.eos_idx)
    enc = torch.randn((rows, 144, FULL.d_model), device=cuda,
                      generator=torch.Generator(cuda).manual_seed(seed))
    return dcfg, impl, enc


def _on_card(model, enc, dcfg, impl, cache, graphed=True):
    """(result, the decode span's counts with the kernels' launch counters'
    gains under "launched")."""
    before = graphs._launched()
    with torch.inference_mode(), profiling.span("decode") as sp:
        if graphed:
            res = bs._graphed_beam_search([model], FULL, [enc], dcfg, torch.bfloat16, None,
                                          impl, cache=cache)
        else:
            res = bs._eager_beam_search([model], FULL, [enc], dcfg, torch.bfloat16, None, impl)
    launched = [n - b for n, b in zip(graphs._launched(), before)]
    return res, {**sp.counts, "launched": launched}


@pytest.mark.cuda
@pytest.mark.parametrize("early", [False, True], ids=["runs_to_L", "ends_early"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_card_graphed_decode_equals_eager(cuda, case, early):
    """Tokens, lengths and log-probs of the warm-up, the capture and two
    replays equal the eager loop's bit for bit, bf16; with EOS favoured the
    captions end early and fewer graphs replay."""
    dcfg, impl, enc = _card_inputs(cuda, case)
    model = _model(FULL, device=cuda)
    _ends_early(model, start=3, slope=2.0, beta=4.0) if early else _no_eos(model)
    cache = graphs.DecodeCache()
    for seed in (0, 0, 0, 1):
        enc = _card_inputs(cuda, case, seed)[2]
        want, eager = _on_card(model, enc, dcfg, impl, cache, graphed=False)
        got, counts = _on_card(model, enc, dcfg, impl, cache)
        assert _equal(got, want), case
        # the same kernels and casts, counted as they run
        assert counts["launched"] == eager["launched"]
        assert counts.get("weight_cast") == eager.get("weight_cast")
    lengths = want.lengths.flatten().tolist()
    if early:
        assert max(lengths) < dcfg.max_seq_len
        assert counts["decode_graph_replay"] < dcfg.max_seq_len
    else:
        assert counts["decode_graph_replay"] == dcfg.max_seq_len


@pytest.mark.cuda
def test_card_public_loop_replays(cuda):
    """`ensemble_beam_search` engages the graphs on the card: the third call
    replays every step."""
    dcfg, impl, enc = _card_inputs(cuda, "b32_beam3_L20_fused")
    model = _model(FULL, device=cuda)
    for _ in range(3):
        with torch.inference_mode(), profiling.span("outer") as sp:
            res = bs.ensemble_beam_search([model], FULL, [enc], dcfg, torch.bfloat16,
                                          step_impl=impl)
    assert sp.counts["decode_graph_replay"] == dcfg.max_seq_len
    assert _equal(res, _on_card(model, enc, dcfg, impl, None, graphed=False)[0])


@pytest.mark.cuda
def test_card_held_result_survives_the_next_call(cuda):
    dcfg, impl, _ = _card_inputs(cuda, "b32_beam3_L20_fused")
    model, cache = _model(FULL, device=cuda), graphs.DecodeCache()
    enc0, enc1 = (_card_inputs(cuda, "b32_beam3_L20_fused", s)[2] for s in (0, 1))
    for _ in range(2):
        held, _ = _on_card(model, enc0, dcfg, impl, cache)
    kept = [t.clone() for t in graphs.tensors(held)]
    other, counts = _on_card(model, enc1, dcfg, impl, cache)
    torch.cuda.synchronize()
    assert counts["decode_graph_replay"] == dcfg.max_seq_len
    assert not _equal(other, held)
    assert all(torch.equal(a, b) for a, b in zip(kept, graphs.tensors(held)))


@pytest.mark.cuda
def test_card_weight_update_recaptures(cuda):
    """A decoder weight updated in place between replays: the next call
    warms up, the one after captures anew, and both equal the eager loop on
    the new weights."""
    dcfg, impl, enc = _card_inputs(cuda, "b32_beam3_L20_fused")
    model, cache = _model(FULL, device=cuda), graphs.DecodeCache()
    for _ in range(3):
        _on_card(model, enc, dcfg, impl, cache)
    with torch.no_grad():
        for layer in model.decoders:  # the fused step's laid-out operands move too
            layer.mha.out_linear.weight.mul_(-1.0)
        model.vocab_linear.weight.mul_(0.5)
    want, _ = _on_card(model, enc, dcfg, impl, None, graphed=False)
    seen = [_on_card(model, enc, dcfg, impl, cache) for _ in range(3)]
    assert "decode_graph_replay" not in seen[0][1]
    assert seen[1][1]["decode_graph_capture"] == dcfg.max_seq_len
    assert all(_equal(res, want) for res, _ in seen)


@pytest.mark.cuda
def test_card_larger_eager_decode_between_replays(cuda):
    """An eager decode of more rows between two replays grows the K2/B16
    workspace; the captured decode holds the old one, so the replays after
    it give what they gave before."""
    dcfg, impl, enc = _card_inputs(cuda, "b32_beam3_L20_fused")
    model, cache = _model(FULL, device=cuda), graphs.DecodeCache()
    for _ in range(3):
        before, _ = _on_card(model, enc, dcfg, impl, cache)
    old = dyn_exp_step._workspace[enc.device]
    big = torch.randn((96, 144, FULL.d_model), device=cuda)
    _on_card(model, big, dcfg, impl, None, graphed=False)
    assert dyn_exp_step._workspace[enc.device] is not old  # grown
    after, counts = _on_card(model, enc, dcfg, impl, cache)
    assert counts["decode_graph_replay"] == dcfg.max_seq_len
    assert _equal(after, before)
    assert _equal(after, _on_card(model, enc, dcfg, impl, None, graphed=False)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_card_quantized_decoder_equals_eager(cuda, mode):
    """A decoder of int8 linears (their kernels and workspaces captured)
    replays as it runs eagerly, with EOS favoured so that captions end
    early."""
    dcfg, impl, enc = _card_inputs(cuda, "b32_beam3_L20_fused")
    model = quantize_decoder(_ends_early(_model(FULL, device=cuda), 3, 2.0, 4.0), mode)
    cache = graphs.DecodeCache()
    for _ in range(3):
        want, eager = _on_card(model, enc, dcfg, impl, cache, graphed=False)
        got, counts = _on_card(model, enc, dcfg, impl, cache)
        assert _equal(got, want)
        assert counts["launched"] == eager["launched"]
    assert counts["decode_graph_replay"] > 2
