"""Shared harness of the port's CPU tests, plus the tests of what it bridges:
configs field for field, weights across the two packages, and import hygiene.

The JAX package is the reference. Inputs are made with numpy from a seed and
handed to both packages; parameters are initialised by the JAX package and
carried into the port with `params/convert.py::state_dict_from_jax`. The JAX
side runs its Pallas kernels as its own tests do, in interpret mode on the
CPU, through the process-wide toggles that `jax_pallas_path()` sets and
restores.
"""
import contextlib
import dataclasses
import pathlib
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from on_device_image_captioning_torch import config as pcfg
from on_device_image_captioning_torch.models.captioner import ExpansionNetV2
from on_device_image_captioning_torch.models.end_to_end import EndExpansionNetV2
from on_device_image_captioning_torch.params.convert import (
    captioner_state_dict,
    state_dict_from_jax,
)
from on_device_image_captioning_tpu import config as jcfg
from on_device_image_captioning_tpu.decode import cache as jdc
from on_device_image_captioning_tpu.models import captioner as jcap
from on_device_image_captioning_tpu.models import common as jcommon
from on_device_image_captioning_tpu.models import end_to_end as je2e
from on_device_image_captioning_tpu.ops import topk as jtopk
from on_device_image_captioning_tpu.params.torch_convert import convert_end_to_end

TINY_SWIN = pcfg.SwinConfig(
    img_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
    window_size=4,
)
TINY_CAP = pcfg.CaptionerConfig(
    d_model=32, N_enc=2, N_dec=2, ff=64, num_heads=4, num_exp_enc_list=(4, 8),
    num_exp_dec=4, vocab_size=50, max_seq_len=20, img_feature_dim=24,
    sos_idx=2, eos_idx=3, pad_idx=0, unk_idx=1,
)
# vocab 1024: the smallest width at which the JAX decode reaches topk_pallas
TINY_E2E = pcfg.ModelConfig(
    swin=TINY_SWIN,
    captioner=dataclasses.replace(TINY_CAP, vocab_size=1024, img_feature_dim=32),
)


def to_jax_swin(cfg: pcfg.SwinConfig, attention_impl: str = None) -> jcfg.SwinConfig:
    """The JAX config of the same backbone, on the port's path unless
    `attention_impl` names another."""
    fields = dataclasses.asdict(cfg)
    return jcfg.SwinConfig(**{**fields, "attention_impl": attention_impl or cfg.attention_impl})


def to_jax_cap(cfg: pcfg.CaptionerConfig) -> jcfg.CaptionerConfig:
    fields = dataclasses.asdict(cfg)
    fields["drop"] = jcfg.DropConfig(**fields["drop"])
    return jcfg.CaptionerConfig(**fields)


def to_jax_model(cfg: pcfg.ModelConfig, attention_impl: str = None) -> jcfg.ModelConfig:
    dtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[cfg.compute_dtype]
    return jcfg.ModelConfig(
        swin=to_jax_swin(cfg.swin, attention_impl),
        captioner=to_jax_cap(cfg.captioner),
        compute_dtype=dtype,
    )


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def e2e_pair(cfg: pcfg.ModelConfig, seed: int):
    """(JAX params tree, port model) holding the same weights."""
    params = je2e.init(jax.random.PRNGKey(seed), to_jax_model(cfg))
    model = EndExpansionNetV2(cfg)
    model.load_state_dict(state_dict_from_jax(numpy_tree(params), cfg), strict=True)
    return params, model.eval()


def captioner_pair(cfg: pcfg.CaptionerConfig, seed: int):
    params = jcap.captioner_init(jax.random.PRNGKey(seed), to_jax_cap(cfg))
    model = ExpansionNetV2(cfg)
    model.load_state_dict(captioner_state_dict(numpy_tree(params)), strict=True)
    return params, model.eval()


@contextlib.contextmanager
def jax_pallas_path():
    """Route the JAX package through its Pallas LayerNorm, dyn-step and top-k
    kernels (interpret mode on the CPU); restore the previous toggles."""
    prev = (jcommon._LN_IMPL, jdc._DYN_STEP_IMPL, jtopk._TOPK_IMPL)
    try:
        jcommon.set_layernorm_impl("pallas")
        jdc.set_dyn_step_impl("pallas")
        yield
    finally:
        jcommon.set_layernorm_impl(prev[0])
        jdc._DYN_STEP_IMPL = prev[1]
        jtopk.set_topk_impl(prev[2])


# ---------------------------------------------------------------------------
# tests of the harness's own bridges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "port_cls, jax_cls, dropped",
    [
        (pcfg.SwinConfig, jcfg.SwinConfig, set()),
        (pcfg.CaptionerConfig, jcfg.CaptionerConfig, set()),
        (pcfg.ModelConfig, jcfg.ModelConfig, set()),
        (pcfg.DecodeConfig, jcfg.DecodeConfig, {"chunk_schedule"}),
        (pcfg.DropConfig, jcfg.DropConfig, set()),
    ],
)
def test_config_fields_match_jax(port_cls, jax_cls, dropped):
    """Field for field with the JAX dataclasses, minus the TPU-only knobs;
    defaults equal, but for the compute dtype (another framework's) and
    `attention_impl` (the JAX default "xla" has no counterpart in the port)."""
    port = {f.name: f for f in dataclasses.fields(port_cls)}
    ref = {f.name: f for f in dataclasses.fields(jax_cls) if f.name not in dropped}
    assert list(port) == list(ref)
    for name, f in ref.items():
        if f.default is not dataclasses.MISSING and name not in ("compute_dtype", "attention_impl"):
            assert port[name].default == f.default, name


def test_config_presets_and_checks():
    assert dataclasses.asdict(pcfg.swin_large_384()) == {
        **dataclasses.asdict(jcfg.swin_large_384()), "attention_impl": "pallas"
    }
    assert pcfg.ATTENTION_IMPLS == ("pallas", "fused")
    with pytest.raises(ValueError, match="attention_impl"):
        pcfg.SwinConfig(attention_impl="xla")
    assert dataclasses.asdict(pcfg.expansionnet_v2_coco()) == dataclasses.asdict(
        jcfg.expansionnet_v2_coco()
    )
    bf16 = pcfg.end_expansionnet_v2_coco(compute_dtype=torch.bfloat16)
    assert bf16.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="outside the vocab"):
        pcfg.CaptionerConfig(vocab_size=50)
    with pytest.raises(ValueError, match="img_feature_dim"):
        pcfg.ModelConfig(swin=TINY_SWIN, captioner=TINY_CAP)


def test_weights_round_trip_through_reference_converter():
    """JAX tree -> state_dict_from_jax -> the JAX package's
    convert_end_to_end (the reference-checkpoint reader) gives the tree back
    exactly; the port loads the same state_dict strictly."""
    cfg = TINY_E2E
    params = numpy_tree(je2e.init(jax.random.PRNGKey(3), to_jax_model(cfg)))
    sd = state_dict_from_jax(params, cfg)
    back = convert_end_to_end(sd, to_jax_model(cfg))
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)  # exact: transposes and reshapes only
    EndExpansionNetV2(cfg).load_state_dict(sd, strict=True)


def test_load_reference_state_dict_drops_buffers():
    """A reference .pth carries DDP prefixes and the attn_mask /
    relative_position_index buffers; the loader drops them and loads strictly."""
    from on_device_image_captioning_torch.params.convert import load_reference_state_dict

    _, model = e2e_pair(TINY_E2E, 4)
    sd = {"module." + k: v.clone() for k, v in model.state_dict().items()}
    sd["module.swin_transf.layers.0.blocks.1.attn_mask"] = torch.zeros(4, 16, 16)
    sd["module.swin_transf.layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(16, 16)
    fresh = EndExpansionNetV2(TINY_E2E)
    load_reference_state_dict(fresh, {"model_state_dict": sd})
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


def test_init_weights_seeded_distributions():
    from on_device_image_captioning_torch.models.end_to_end import init_weights

    a = init_weights(EndExpansionNetV2(TINY_E2E), torch.Generator().manual_seed(0))
    b = init_weights(EndExpansionNetV2(TINY_E2E), torch.Generator().manual_seed(0))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)  # same seed, same weights
    table = a.swin_transf.layers[0].blocks[0].attn.relative_position_bias_table.detach()
    assert float(table.abs().max()) <= 0.04 + 1e-7  # trunc-normal(0.02) at +-2 std
    w = a.encoders[0].ff.linear_1.weight.detach()
    assert float(w.abs().max()) <= (6.0 / sum(w.shape)) ** 0.5 + 1e-7  # xavier bound
    assert float(a.encoders[0].norm_1.weight.detach().min()) == 1.0
    assert float(a.input_linear.bias.detach().abs().max()) == 0.0


def test_port_imports_neither_jax_nor_triton():
    """Importing every module of the port (the package is walked, the
    `train` and `deploy` subpackages included), running both backbone paths,
    taking an XE training step on each and captioning with the w8a8-quantized
    model leaves jax, triton and every module of the JAX package out of
    sys.modules, and on the CPU no kernel launch counter moves."""
    code = textwrap.dedent(
        """
        import dataclasses, importlib, pkgutil, sys
        import numpy as np, torch
        import on_device_image_captioning_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
        mods = {n: importlib.import_module(n) for n in names}
        assert len(names) >= 30, names
        for leaf in ("api", "cli.demo", "cli.breakdown", "cli.quantize", "data.text",
                     "decode.sampling", "deploy.quantization", "ops.quant_matmul",
                     "ops.stage_boundary",
                     "ops.swin_block_fused", "ops.window_layout", "utils.image",
                     "train.losses", "train.radam", "train.schedules", "train.train_step"):
            assert port.__name__ + "." + leaf in mods, leaf
        from on_device_image_captioning_torch import api, config
        from on_device_image_captioning_torch.deploy import quantization
        from on_device_image_captioning_torch.models import end_to_end
        from on_device_image_captioning_torch.train import radam, train_step
        from on_device_image_captioning_torch.ops import (
            dyn_exp_step, layernorm, quant_matmul, stage_boundary, swin_block_fused, topk,
            window_attention)
        for impl in config.ATTENTION_IMPLS:
            cfg = config.ModelConfig(
                swin=config.SwinConfig(img_size=32, patch_size=4, embed_dim=16,
                    depths=(2, 2), num_heads=(2, 4), window_size=4, attention_impl=impl),
                captioner=config.CaptionerConfig(d_model=32, N_enc=1, N_dec=1, ff=64,
                    num_heads=4, num_exp_enc_list=(4,), num_exp_dec=4, vocab_size=1024,
                    max_seq_len=8, img_feature_dim=32, sos_idx=2, eos_idx=3,
                    pad_idx=0, unk_idx=1))
            model = end_to_end.init_weights(end_to_end.EndExpansionNetV2(cfg),
                                            torch.Generator().manual_seed(0))
            imgs = np.zeros((1, 32, 32, 3), np.uint8)
            for step_impl in ("pallas", "pallas_fused"):
                api.Captioner(model, cfg, {"beam_size": 2, "beam_max_seq_len": 6}, device="cpu",
                              step_impl=step_impl)(imgs)
            step = train_step.make_xe_step(model, cfg, radam.PlainRAdam(model.parameters(), 1e-3))
            batch = {"enc_input": torch.from_numpy(imgs),
                     "captions": torch.tensor([[2, 5, 6, 3, 0]])}
            assert torch.isfinite(step(batch, torch.Generator().manual_seed(0))["loss"])
            quantization.quantize_model(model, "w8a8")
            api.Captioner(model, cfg, {"beam_size": 2, "beam_max_seq_len": 6}, device="cpu")(imgs)
        counts = [m.launches for m in (dyn_exp_step, layernorm, topk, window_attention)]
        counts += [stage_boundary.patch_embed_launches, stage_boundary.downsample_launches,
                   swin_block_fused.attn_half_launches, swin_block_fused.mlp_half_launches,
                   swin_block_fused.transition_launches, swin_block_fused.block_launches,
                   dyn_exp_step.cross_launches, swin_block_fused.block_train_launches,
                   swin_block_fused.attn_half_train_launches,
                   swin_block_fused.mlp_half_train_launches,
                   swin_block_fused.attn_bwd_launches, swin_block_fused.mlp_bwd_launches,
                   quant_matmul.launches, swin_block_fused.mlp_half_a8_launches]
        assert counts == [0] * 18, counts
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "triton", "on_device_image_captioning_tpu")]
        assert not bad, bad
        print("clean")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=str(REPO),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


REPO = pathlib.Path(__file__).resolve().parents[1]
# an import statement that names jax or the JAX package (prose that cites
# `on_device_image_captioning_tpu/file.py:line` is fine)
_FOREIGN_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|jaxlib|on_device_image_captioning_tpu)\b"
    r"|^\s*from\s+\S+\s+import\s+.*\bon_device_image_captioning_tpu\b"
    r"|import_module\(\s*[\"'](jax|on_device_image_captioning_tpu)",
    re.MULTILINE,
)


def test_port_sources_name_no_jax_import():
    """No source of the port, nor chip_smoke.py, imports jax or anything of
    the JAX package."""
    sources = sorted((REPO / "on_device_image_captioning_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) >= 30
    assert any(path.parent.name == "train" for path in sources)
    for path in sources:
        found = _FOREIGN_IMPORT.search(path.read_text())
        assert found is None, f"{path.relative_to(REPO)}: {found.group(0).strip()!r}"
    assert _FOREIGN_IMPORT.search("    from on_device_image_captioning_tpu.data.text import Vocab")
    assert _FOREIGN_IMPORT.search("import jax.numpy as jnp")
    assert not _FOREIGN_IMPORT.search("Replaces `on_device_image_captioning_tpu/ops/topk.py::f`")
