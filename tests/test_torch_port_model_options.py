"""``norm_eval``, sampled BatchNorm statistics (``bn_stats_images``) and
``with_orconv=False`` against the JAX package, on the CPU (the plain
versions of the kernels).

R-18, 2 images of 64^2, seeded, float32, random running statistics, as
tests/test_torch_port_frozen_bn.py: one train-mode forward (head outputs
within 1e-4, running statistics within 1e-5, unchanged under
``norm_eval``) and one train step (loss items within 1e-4, parameters and
running statistics rtol 1e-4, atol 1e-5) for each option. Without the
ORConv also serving: the folded model's head outputs within the head's
2e-3 of the folded JAX model's (tests/test_torch_port_models.py), the
weights read from the JAX tree, the bfloat16 cast keeping the plain
``or_conv`` and the ODM stacks in float32 (as flax promotes them), and the
``orconv`` quantisation group empty. The train bench's model flags set
the same fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2anet_tpu.models.fold import fold_bn_for_eval
from s2anet_tpu_torch.models.fold import fold_bn
from s2anet_tpu_torch.ops.quant import QUANT_SCOPE_ALL, quant_modules

from test_torch_port_frozen_bn import (B, IMG, OUT_KEYS, check_forward, check_train_step,
                                       frozen_bn_paths, jax_variables, port_model)

OPTIONS = {
    "norm_eval": ({"norm_eval": True}, frozen_bn_paths(-1, norm_eval=True)),
    "bn_stats_images": ({"bn_stats_images": 1}, lambda path: False),
    "with_orconv": ({"with_orconv": False}, lambda path: False),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_forward_matches_jax(option):
    kw, frozen = OPTIONS[option]
    assert check_forward(kw, frozen) == (40 if option == "norm_eval" else 0)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_train_step_matches_jax(option):
    kw, _ = OPTIONS[option]
    model = check_train_step(kw)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if option == "norm_eval":
        # every BatchNorm in inference mode, its gamma and beta trained
        assert not any(m.training for m in bns)
        assert all(m.weight.grad is not None and m.weight.grad.abs().sum() > 0 for m in bns)
    else:
        assert all(m.training for m in bns)
    assert all(m.stats_images == kw.get("bn_stats_images", 0) for m in bns)


def test_no_orconv_folded_serving_matches_jax():
    kw = {"with_orconv": False}
    jmodel, variables = jax_variables(kw)
    model = port_model(kw, variables).eval()
    assert fold_bn(model) == 1 + 8 * 2 + 3
    jfold, jvars = fold_bn_for_eval(jmodel, variables)
    imgs = np.random.default_rng(6).uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jfold.apply(v, x))(jvars, jnp.asarray(imgs))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    for key in OUT_KEYS:
        for lvl, (g, w) in enumerate(zip(got[key], want[key])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3,
                                       err_msg=f"{key}[{lvl}]")
    head = model.head
    assert head.or_conv.weight.shape == (256, 256, 3, 3)
    assert head.odm_cls_ls[0][0].in_channels == 256
    np.testing.assert_array_equal(  # HWIO -> OIHW
        head.or_conv.weight.detach().numpy(),
        np.transpose(variables["params"]["head"]["or_conv"]["kernel"], (3, 2, 0, 1)))

    # the bfloat16 model: or_conv and the ODM stacks stay float32
    model.cast(torch.bfloat16)
    keep = [head.or_conv, head.odm_reg_ls, head.odm_cls_ls] + list(head.prediction_heads())
    for m in keep:
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert head.fam_reg_ls[0][0].weight.dtype == torch.bfloat16
    with torch.no_grad():
        out = model(torch.from_numpy(imgs).permute(0, 3, 1, 2).bfloat16())
    assert all(o.dtype == torch.float32 and torch.isfinite(o).all()
               for key in OUT_KEYS for o in out[key])
    # the orconv quantisation group is empty without the ORConv
    model.set_quant("calib", QUANT_SCOPE_ALL)
    assert type(head.or_conv).__name__ == "Conv2d"
    assert all(name != "head.or_conv" for name, _ in quant_modules(model))


def test_bench_takes_the_model_options():
    """The train bench's model flags set the ``ModelConfig`` fields; a
    training run (``--config``) refuses them (it reads the config)."""
    from s2anet_tpu_torch.train.__main__ import parse_opt, setup

    opt = parse_opt(["--device", "cpu", "--backbone", "resnet18", "--img-size", "64",
                     "--batch-size", "2", "--synthetic", "1", "--frozen-stages", "1",
                     "--norm-eval", "--bn-stats-images", "1", "--no-orconv"])
    cfg, model, optimizer, _, _ = setup(opt)
    assert (cfg.frozen_stages, cfg.norm_eval, cfg.bn_stats_images, cfg.with_orconv) == (
        1, True, 1, False)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert not any(m.training for m in bns) and all(m.stats_images == 1 for m in bns)
    assert not model.head.with_orconv
    frozen = {id(p) for n, p in model.named_parameters()
              if n.startswith(("backbone.backbone.0.", "backbone.backbone.1."))}
    assert frozen and not frozen & {id(p) for p in optimizer.params}
    with pytest.raises(SystemExit):
        parse_opt(["--config", "c.yaml", "--frozen-stages", "1"])
