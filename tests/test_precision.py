"""Every matmul of resize, warp and match_template names its precision.

On a GPU, ``Precision.DEFAULT`` runs float32 dots in TF32; the ops
choose per call: ``DEFAULT`` only where every operand has at most 11
significant bits (u8 data with Q11 bilinear weights, made exact by the
resize's hi/lo split), ``HIGHEST`` everywhere else.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

import vacv_tpu as vc

D, HI = lax.Precision.DEFAULT, lax.Precision.HIGHEST


def _dot_precisions(fn, *args):
    """The precision config of every dot_general in fn's jaxpr."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr if hasattr(sub.jaxpr, "eqns")
                             else sub.jaxpr.jaxpr)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    assert found, "no dot_general traced"
    return found


def _img(dtype, h=96, w=128):
    return jnp.asarray(np.random.default_rng(0).integers(
        0, 256, (h, w, 3)).astype(dtype))


@pytest.mark.parametrize("dtype,mode,want", [
    (np.uint8, vc.INTER_LINEAR, D),
    (np.float32, vc.INTER_LINEAR, HI),
    (np.uint8, vc.INTER_CUBIC, HI),
    (np.uint8, vc.INTER_AREA, HI),
    (np.float32, vc.INTER_NEAREST, HI),
])
def test_resize_dot_precisions(dtype, mode, want):
    precs = _dot_precisions(
        lambda x: vc.resize(x, (40, 30), interpolation=mode).data,
        _img(dtype))
    assert precs and all(p == (want, want) for p in precs), precs


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_separable_warp_dots_are_highest(dtype):
    m = np.array([[0.9, 0.0, 5.0], [0.0, 1.1, -8.0]], np.float32)
    precs = _dot_precisions(
        lambda x: vc.warp_affine(x, m, (100, 80)).data, _img(dtype))
    assert all(p == (HI, HI) for p in precs), precs


def test_match_template_dots_are_highest():
    img = _img(np.float32)
    precs = _dot_precisions(
        lambda x, t: vc.match_template(x, t, vc.TM_CCOEFF_NORMED).data,
        img, img[10:26, 20:36])
    assert all(p == (HI, HI) for p in precs), precs


def test_pipeline_dots_name_their_precision():
    """The cfg-4 chain through Preprocessor.batch_fn: the u8 bilinear
    resize at DEFAULT, nothing left implicit."""
    from vacv_tpu.models import PreprocessConfig, Preprocessor

    pre = Preprocessor(PreprocessConfig(crop_rect=vc.VRect(4, 2, 124, 90),
                                        out_size=(32, 32)))
    precs = _dot_precisions(pre.batch_fn, _img(np.uint8)[None])
    assert all(p == (D, D) for p in precs), precs
