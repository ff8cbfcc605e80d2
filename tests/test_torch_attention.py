"""The port's attention core (tgb_tgn_dgl_tpu_torch/ops/attention.py)
against the JAX package's: the plain torch version against the jnp
reference and the Pallas kernels (interpret mode), forward and both
gradients, with and without the same injected drop mask, and the forward
under no_grad; the plain backward from the residual against the Pallas
backward kernels; the choice of the inference route (no residual).

Tolerance 1e-5 (abs and rel) on the forward and 1e-4 on the gradients,
fp32 on both sides: the softmax and the Kp-long sums run in another order
in the two frameworks (and the Pallas path adds a transpose and 512-row
padding), which moves the last bits; the gradient sums are longer."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tgb_tgn_dgl_tpu.ops.pallas_attention import (
    attention_core as jax_attention_core,
    attention_core_reference as jax_attention_reference)
from tgb_tgn_dgl_tpu_torch.ops import attention as port

SLOPE = 0.2
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(R, Kp, H, seed, masked_rows=(), drop=False):
    rng = np.random.default_rng(seed)
    el = rng.normal(size=(R, Kp, H)).astype(np.float32)
    er = rng.normal(size=(R, H)).astype(np.float32)
    mask = rng.random((R, Kp)) < 0.7
    mask[:, 0] = True                  # real roots always hold a column
    mask[list(masked_rows)] = False    # padded root slots: all masked
    g = rng.normal(size=(R, H)).astype(np.float32)
    dm = None
    if drop:
        keep = 0.8
        dm = ((rng.random((R, Kp, H)) < keep) / keep).astype(np.float32)
    return el, er, mask, g, dm


def _jax_fwd_grads(fn, el, er, mask, g, dm):
    def loss(el, er):
        out = fn(el, er, jnp.asarray(mask),
                 None if dm is None else jnp.asarray(dm))
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(jnp.asarray(el),
                                                       jnp.asarray(er))
    return [np.asarray(out)] + [np.asarray(x) for x in grads]


def _port_fwd_grads(el, er, mask, g, dm):
    tel = torch.tensor(el, requires_grad=True)
    ter = torch.tensor(er, requires_grad=True)
    out = port.attention_core(tel, ter, torch.from_numpy(mask), SLOPE,
                              None if dm is None else torch.from_numpy(dm))
    (out * torch.from_numpy(g)).sum().backward()
    return [out.detach().numpy(), tel.grad.numpy(), ter.grad.numpy()]


CASES = [
    # (R, Kp, H, masked rows): Kp = K+1+P at K=10, P=32; an odd Kp; R*H
    # not a multiple of 512 (the Pallas tile) in every case
    pytest.param(96, 43, 8, (5, 77), id="Kp43"),
    pytest.param(37, 17, 4, (0, 36), id="Kp17"),
    pytest.param(13, 5, 3, (), id="tiny"),
]


@pytest.mark.parametrize("drop", [False, True], ids=["plain", "drop"])
@pytest.mark.parametrize("R,Kp,H,masked", CASES)
@pytest.mark.parametrize("against", ["reference", "pallas"])
def test_plain_matches_jax(R, Kp, H, masked, drop, against):
    el, er, mask, g, dm = _inputs(R, Kp, H, seed=R * Kp, masked_rows=masked,
                                  drop=drop)
    if against == "reference":
        def fn(el, er, m, dm):
            return jax_attention_reference(el, er, m, SLOPE, drop_mask=dm)
    else:
        def fn(el, er, m, dm):
            return jax_attention_core(el, er, m, SLOPE, use_pallas=True,
                                      interpret=True, drop_mask=dm)
    want = _jax_fwd_grads(fn, el, er, mask, g, dm)
    got = _port_fwd_grads(el, er, mask, g, dm)
    for name, a, b, tol in zip(("out", "d_el", "d_er"), got, want,
                               (FWD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("drop", [False, True], ids=["plain", "drop"])
@pytest.mark.parametrize("R,Kp,H,masked", CASES)
def test_backward_reference_matches_pallas(R, Kp, H, masked, drop):
    """``attention_bwd_reference`` from the residual ``a`` against
    ``jax.vjp`` of the Pallas path, which runs ``_bwd_kernel`` /
    ``_bwd_kernel_drop`` in interpret mode."""
    el, er, mask, g, dm = _inputs(R, Kp, H, seed=R + 3 * Kp,
                                  masked_rows=masked, drop=drop)
    _, vjp = jax.vjp(
        lambda el, er: jax_attention_core(
            el, er, jnp.asarray(mask), SLOPE, use_pallas=True,
            interpret=True, drop_mask=None if dm is None else jnp.asarray(dm)),
        jnp.asarray(el), jnp.asarray(er))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tel, ter, tmask = map(torch.from_numpy, (el, er, mask))
    a = port.attention_probs_reference(tel, ter, tmask, SLOPE)
    got = port.attention_bwd_reference(
        tel, ter, tmask, a, torch.from_numpy(g), SLOPE,
        None if dm is None else torch.from_numpy(dm))
    for name, x, y in zip(("d_el", "d_er"), got, want):
        np.testing.assert_allclose(x.numpy(), y, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("R,Kp,H,masked", CASES)
def test_no_grad_matches_jax(R, Kp, H, masked):
    """``attention_core`` under no_grad on CPU tensors, which take the plain
    version before any route choice: this covers the CPU dispatch only.
    The inference kernel itself is held against the plain version in
    ``test_cuda_tensor_goes_through_kernel`` (route "infer")."""
    el, er, mask, _, _ = _inputs(R, Kp, H, seed=R + Kp, masked_rows=masked)
    want = np.asarray(jax_attention_reference(
        jnp.asarray(el), jnp.asarray(er), jnp.asarray(mask), SLOPE))
    with torch.no_grad():
        got = port.attention_core(torch.tensor(el, requires_grad=True),
                                  torch.tensor(er, requires_grad=True),
                                  torch.from_numpy(mask), SLOPE)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


ROUTES = [
    # (autograd on, (el' requires grad, er requires grad), drop mask,
    #  inference route)
    pytest.param(True, (True, True), False, False, id="grad"),
    pytest.param(True, (False, True), False, False, id="grad_er_only"),
    pytest.param(True, (True, False), False, False, id="grad_el_only"),
    pytest.param(True, (False, False), False, True, id="no_requires_grad"),
    pytest.param(False, (True, True), False, True, id="no_grad"),
    pytest.param(False, (True, True), True, False, id="no_grad_drop"),
    pytest.param(True, (False, False), True, False, id="drop"),
]


@pytest.mark.parametrize("grad_enabled,requires,drop,want", ROUTES)
def test_infer_route_choice(grad_enabled, requires, drop, want):
    el = torch.zeros((4, 3, 2), requires_grad=requires[0])
    er = torch.zeros((4, 2), requires_grad=requires[1])
    dm = torch.ones((4, 3, 2)) if drop else None
    with torch.set_grad_enabled(grad_enabled):
        assert port.infer_route(el, er, dm) is want


def test_fully_masked_rows_give_zeros():
    el, er, mask, g, dm = _inputs(16, 9, 2, seed=3, masked_rows=(4, 11),
                                  drop=True)
    out, d_el, d_er = _port_fwd_grads(el, er, mask, g, dm)
    for rows in (out[[4, 11]], d_el[[4, 11]], d_er[[4, 11]]):
        assert np.all(rows == 0.0)
    assert np.isfinite(out).all() and np.isfinite(d_el).all()


def test_cpu_tensor_takes_plain_version_without_launch():
    el, er, mask, _, _ = _inputs(8, 6, 2, seed=4)
    before = dict(port.launch_counts)
    out = port.attention_core(torch.from_numpy(el), torch.from_numpy(er),
                              torch.from_numpy(mask), SLOPE)
    want = port.attention_core_reference(torch.from_numpy(el),
                                         torch.from_numpy(er),
                                         torch.from_numpy(mask), SLOPE)
    assert torch.equal(out, want)
    assert port.launch_counts == before


def test_kernel_wrappers_refuse_cpu_tensors():
    el, er, mask, g, _ = _inputs(8, 6, 2, seed=5)
    el, er, mask, g = map(torch.from_numpy, (el, er, mask, g))
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_fwd(el, er, mask, SLOPE)
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_fwd_infer(el, er, mask, SLOPE)
    with pytest.raises(ValueError, match="CUDA"):
        port.attention_bwd(el, er, mask, el, g, SLOPE)


@pytest.mark.parametrize("drop", [False, True], ids=["plain", "drop"])
def test_forward_wrappers_refuse_more_than_32_heads(drop):
    el, er, mask, _, dm = _inputs(4, 3, 33, seed=7, drop=drop)
    el, er, mask = map(torch.from_numpy, (el, er, mask))
    dm = None if dm is None else torch.from_numpy(dm)
    with pytest.raises(ValueError, match="at most 32 heads"):
        port.attention_fwd(el, er, mask, SLOPE, dm)
    if not drop:
        with pytest.raises(ValueError, match="at most 32 heads"):
            port.attention_fwd_infer(el, er, mask, SLOPE)


@pytest.mark.parametrize("drop", [False, True], ids=["plain", "drop"])
def test_backward_wrapper_refuses_more_than_32_heads(drop):
    el, er, mask, g, dm = _inputs(4, 3, 33, seed=8, drop=drop)
    el, er, mask, g = map(torch.from_numpy, (el, er, mask, g))
    dm = None if dm is None else torch.from_numpy(dm)
    with pytest.raises(ValueError, match="at most 32 heads"):
        port.attention_bwd(el, er, mask, el, g, SLOPE, dm)


def _cuda_leaf(x, misaligned):
    """``x`` on the card as a tensor that takes a gradient; with
    ``misaligned`` its data starts 4 bytes into a larger buffer."""
    t = torch.from_numpy(x).to("cuda")
    if misaligned:
        t = torch.empty(t.numel() + 1, device="cuda")[1:].view(t.shape)
        t.copy_(torch.from_numpy(x))
    return t.requires_grad_(True)


CUDA_CASES = [
    # (R, Kp, H, el' misaligned): the float4 route; the float route with a
    # row longer than one chunk; the float route forced by alignment; the
    # float route on a short row
    pytest.param(64, 43, 8, False, id="Kp43"),
    pytest.param(40, 200, 3, False, id="H3_Kp200"),
    pytest.param(64, 43, 8, True, id="misaligned"),
    pytest.param(999, 17, 3, False, id="H3_Kp17"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("R,Kp,H,misaligned", CUDA_CASES)
@pytest.mark.parametrize("route", ["plain", "drop", "infer"])
def test_cuda_tensor_goes_through_kernel(route, R, Kp, H, misaligned):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    drop = route == "drop"
    el, er, mask, g, dm = _inputs(R, Kp, H, seed=6, masked_rows=(3,),
                                  drop=drop)
    dev = torch.device("cuda")
    tel = _cuda_leaf(el, misaligned)
    ter = _cuda_leaf(er, False)
    tmask = torch.from_numpy(mask).to(dev)
    tdm = None if dm is None else torch.from_numpy(dm).to(dev)
    want = _port_fwd_grads(el, er, mask, g, dm)
    port.reset_launch_counts()
    if route == "infer":
        with torch.no_grad():
            out = port.attention_core(tel, ter, tmask, SLOPE)
        torch.cuda.synchronize()
        assert port.launch_counts == {
            name: int(name == "attention_fwd_infer") for name in port.KERNELS}
        np.testing.assert_allclose(out.cpu().numpy(), want[0],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        return
    out = port.attention_core(tel, ter, tmask, SLOPE, tdm)
    (out * torch.from_numpy(g).to(dev)).sum().backward()
    torch.cuda.synchronize()
    fwd, bwd = (("attention_fwd_drop", "attention_bwd_drop") if drop
                else ("attention_fwd", "attention_bwd"))
    assert port.launch_counts == {name: int(name in (fwd, bwd))
                                  for name in port.KERNELS}
    for a, b in zip((out, tel.grad, ter.grad), want):
        np.testing.assert_allclose(a.detach().cpu().numpy(), b,
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    # the residual: the softmax probabilities before dropout
    a = port.attention_fwd(tel.detach(), ter.detach(), tmask, SLOPE, tdm)[1]
    probs = port.attention_probs_reference(
        torch.from_numpy(el), torch.from_numpy(er), torch.from_numpy(mask),
        SLOPE)
    np.testing.assert_allclose(a.cpu().numpy(), probs.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("R,Kp,H,misaligned", CUDA_CASES)
@pytest.mark.parametrize("drop", [False, True], ids=["plain", "drop"])
def test_cuda_backward_kernel_matches_reference(drop, R, Kp, H, misaligned):
    """The backward kernel alone against ``attention_bwd_reference`` on the
    same residual ``a`` and output gradient."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    el, er, mask, g, dm = _inputs(R, Kp, H, seed=9, masked_rows=(3,),
                                  drop=drop)
    tel = _cuda_leaf(el, misaligned).detach()
    ter, tmask, tg = (torch.from_numpy(x).to("cuda") for x in (er, mask, g))
    tdm = None if dm is None else torch.from_numpy(dm).to("cuda")
    a = port.attention_probs_reference(tel, ter, tmask, SLOPE)
    want = port.attention_bwd_reference(tel, ter, tmask, a, tg, SLOPE, tdm)
    got = port.attention_bwd(tel, ter, tmask, a, tg, SLOPE, tdm)
    torch.cuda.synchronize()
    for name, x, y in zip(("d_el", "d_er"), got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)
        assert x[3].abs().max() == 0, f"{name}: fully masked row not zero"


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["plain", "drop", "infer"])
def test_cuda_kernels_take_no_root_slot(route):
    """R = 0 (an empty batch): every entry point launches nothing and
    returns empty outputs, as the plain version does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    el = torch.zeros((0, 43, 8), device="cuda", requires_grad=True)
    er = torch.zeros((0, 8), device="cuda", requires_grad=True)
    mask = torch.zeros((0, 43), dtype=torch.bool, device="cuda")
    dm = torch.ones((0, 43, 8), device="cuda") if route == "drop" else None
    with torch.set_grad_enabled(route != "infer"):
        out = port.attention_core(el, er, mask, SLOPE, dm)
    assert out.shape == (0, 8)
    if route != "infer":
        out.sum().backward()
        assert el.grad.shape == el.shape and er.grad.shape == er.shape
    torch.cuda.synchronize()
