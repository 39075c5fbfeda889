"""The optimizer step of training in one pass: the feature gradients'
combination, the quaternions' normalization, the containment of
non-finite gradient rows, both Adam chains and the loss guard, as one CUDA
kernel (`csrc/optimizer_update.cu`) behind `optimizer_update`, which every
training step calls (`training/step.py::TrainStep.update`).

The step takes the stored features as they are, quaternions unnormalized:
the projection normalizes each quaternion where it reads it, with the norm
held constant, so its gradient is the one with respect to q / |q| divided
by |q|. The update normalizes q, multiplies the quaternion's gradient
columns by the same floored norm and takes Adam on q / |q|
(`normalize_quaternions`), so that no step copies the (N, 56) features.

`optimizer_update_torch` is its plain version: `normalize_quaternions`,
`contain_gradients`, two `adam_update`s (`AdamGroup`) and `keep_if_ok`.
CPU tensors take it; CUDA tensors launch the kernel or raise; any other
device raises. There is no fallback. The kernel rounds as the plain
version's torch ops do on the card, so the two agree bit for bit there.

The optimizer's outputs are new tensors: nothing is modified in place.

The batch step's running sums (`parallel/sharding.py`) take one view at a
time through `accumulate_view_gradients`: the view's feature gradients
combined as `combine_feature_gradients` combines them and added into the
feature sum, its position gradient into the position sum, in place, as one
CUDA kernel (`csrc/accumulate_view.cu`) on the card; its plain version,
`accumulate_view_gradients_torch`, is the torch chain, to the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops._build import AdamGroupArgs, launch, on_card
from .adam import AdamGroup, AdamState

NUM_FEATURES = 56


class OptimizerUpdate(NamedTuple):
    """What one optimizer step leaves: the parameters and Adam states
    after it (as they were when the loss was not finite), the contained
    position gradient and the number of slots whose gradient rows were
    zeroed (int32, 0-d)."""
    feats: torch.Tensor
    pc: torch.Tensor
    opt_features: AdamState
    opt_positions: AdamState
    grad_pc: torch.Tensor
    nonfinite_grad_rows: torch.Tensor


def combine_feature_gradients(grad_feats_raster, grad_scale, band_mask,
                              grad_feats_direct=None):
    """The rasterizer-path feature gradients scaled per group and masked
    to the active SH bands, plus the regularizer's (+0.0 without one, as
    adding zeros gives)."""
    scaled = grad_feats_raster * grad_scale * band_mask
    return scaled + (0.0 if grad_feats_direct is None else grad_feats_direct)


def accumulate_view_gradients_torch(sum_feats, sum_pc, grad_feats_raster,
                                    grad_pc, grad_scale, band_mask,
                                    grad_feats_direct=None, first=False):
    """The plain version of `accumulate_view_gradients`: the sums zeroed on
    the first view, then the view's combined feature gradients and its
    position gradient added."""
    grad_feats = combine_feature_gradients(grad_feats_raster, grad_scale,
                                           band_mask, grad_feats_direct)
    if first:
        sum_feats.zero_()
        sum_pc.zero_()
    sum_feats.add_(grad_feats)
    sum_pc.add_(grad_pc)
    return sum_feats, sum_pc


def accumulate_view_gradients(sum_feats, sum_pc, grad_feats_raster, grad_pc,
                              grad_scale, band_mask, grad_feats_direct=None,
                              first=False):
    """Add one view's gradients into a batch step's running sums, in place:
    `sum_feats` (N, 56) += `combine_feature_gradients(grad_feats_raster,
    grad_scale, band_mask, grad_feats_direct)`, `sum_pc` (N, 3) +=
    `grad_pc`; on the `first` view the sums are taken as zeros and not read
    (they may come from `torch.empty`). Every value is rounded as the chain
    of torch ops rounds it (zeros, the combination, the two sums), so the
    sums are bit for bit the same on either path. Returns (sum_feats,
    sum_pc).

    CPU tensors take `accumulate_view_gradients_torch`; CUDA tensors launch
    the kernel (the sums must be contiguous, `sum_feats` 16-byte aligned);
    any other device raises."""
    n = sum_feats.shape[0]
    shapes = [("sum_feats", sum_feats, (n, NUM_FEATURES)),
              ("sum_pc", sum_pc, (n, 3)),
              ("grad_feats_raster", grad_feats_raster, (n, NUM_FEATURES)),
              ("grad_pc", grad_pc, (n, 3)),
              ("grad_scale", grad_scale, (NUM_FEATURES,)),
              ("band_mask", band_mask, (NUM_FEATURES,))]
    if grad_feats_direct is not None:
        shapes.append(("grad_feats_direct", grad_feats_direct,
                       (n, NUM_FEATURES)))
    for name, t, shape in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != sum_feats.device:
            raise ValueError(f"{name} is on {t.device}, sum_feats on "
                             f"{sum_feats.device}")
    if not on_card(sum_feats, "accumulate_view_gradients"):
        return accumulate_view_gradients_torch(
            sum_feats, sum_pc, grad_feats_raster, grad_pc, grad_scale,
            band_mask, grad_feats_direct, first)
    if not (sum_feats.is_contiguous() and sum_pc.is_contiguous()
            and sum_feats.data_ptr() % 16 == 0):
        raise ValueError("the sums are written in place: they must be "
                         "contiguous, sum_feats 16-byte aligned")
    grad, scale, mask = (_aligned(t) for t in (grad_feats_raster, grad_scale,
                                               band_mask))
    direct = None if grad_feats_direct is None else _aligned(
        grad_feats_direct)
    grad_pc = grad_pc.contiguous()
    launch("accumulate_view", n, grad.data_ptr(),
           None if direct is None else direct.data_ptr(), scale.data_ptr(),
           mask.data_ptr(), grad_pc.data_ptr(), int(first),
           sum_feats.data_ptr(), sum_pc.data_ptr(), device=sum_feats.device)
    return sum_feats, sum_pc


def normalize_quaternions(feats, grad_feats):
    """(features, gradient) with each slot's quaternion q (columns 0-3)
    divided by its norm and the quaternion's gradient columns multiplied by
    it: the gradient with respect to q with the norm held constant becomes
    the one with respect to q / |q|. The squares are summed in the order
    q0, q1, q2, q3, as the kernel sums them, and the norm is floored at
    1e-12, so that an all-zero slot of the pool stays 0. The square root
    is taken in float64 and rounded once to float32, which is the
    correctly rounded float32 root on every device, as the kernel's
    `sqrtf`: torch's vectorized float32 `sqrt` on the CPU is not (it
    misses by an ulp on some 0.6% of inputs)."""
    q = feats[:, 0:4]
    squares = (q[:, 0:1] * q[:, 0:1] + q[:, 1:2] * q[:, 1:2]
               + q[:, 2:3] * q[:, 2:3] + q[:, 3:4] * q[:, 3:4])
    norm = torch.clamp(torch.sqrt(squares.double()).float(), min=1e-12)
    return (torch.cat([q / norm, feats[:, 4:]], dim=1),
            torch.cat([grad_feats[:, 0:4] * norm, grad_feats[:, 4:]], dim=1))


def contain_gradients(grad_pc, grad_feats):
    """Zero the non-finite gradient rows (a culled degenerate splat's VJP
    can still give 0 * inf = NaN), so that one point cannot poison its Adam
    moments. Returns (grad_pc, grad_feats, number of points zeroed)."""
    feat_row_ok = torch.isfinite(grad_feats).all(dim=1, keepdim=True)
    pc_row_ok = torch.isfinite(grad_pc).all(dim=1, keepdim=True)
    nonfinite_grad_rows = (~feat_row_ok[:, 0] | ~pc_row_ok[:, 0]).sum(
        dtype=torch.int32)
    return (torch.where(pc_row_ok, grad_pc, torch.zeros_like(grad_pc)),
            torch.where(feat_row_ok, grad_feats,
                        torch.zeros_like(grad_feats)),
            nonfinite_grad_rows)


def keep_if_ok(loss_ok, new, old):
    """`new` where the loss was finite, else `old` (NamedTuples of tensors):
    a non-finite loss poisons every gradient."""
    return type(old)(*(torch.where(loss_ok, a, b) for a, b in zip(new, old)))


def optimizer_update_torch(feats, grad_feats, pc, grad_pc,
                           opt_features: AdamState, opt_positions: AdamState,
                           features: AdamGroup, positions: AdamGroup,
                           loss_ok, grad_scale=None, band_mask=None,
                           grad_feats_direct=None) -> OptimizerUpdate:
    """The plain version of `optimizer_update`."""
    if grad_scale is not None:
        grad_feats = combine_feature_gradients(grad_feats, grad_scale,
                                               band_mask, grad_feats_direct)
    feats, grad_feats = normalize_quaternions(feats, grad_feats)
    grad_pc, grad_feats, nonfinite_grad_rows = contain_gradients(grad_pc,
                                                                 grad_feats)
    new_feats, opt_f = features(feats, grad_feats, opt_features)
    new_pc, opt_p = positions(pc, grad_pc, opt_positions)
    return OptimizerUpdate(
        torch.where(loss_ok, new_feats, feats),
        torch.where(loss_ok, new_pc, pc),
        keep_if_ok(loss_ok, opt_f, opt_features),
        keep_if_ok(loss_ok, opt_p, opt_positions),
        grad_pc, nonfinite_grad_rows)


def _check(feats, grad_feats, pc, grad_pc, opt_features, opt_positions,
           loss_ok, grad_scale, band_mask, grad_feats_direct):
    n = feats.shape[0]
    shapes = [("feats", feats, (n, NUM_FEATURES)),
              ("grad_feats", grad_feats, (n, NUM_FEATURES)),
              ("opt_features.mu", opt_features.mu, (n, NUM_FEATURES)),
              ("opt_features.nu", opt_features.nu, (n, NUM_FEATURES)),
              ("pc", pc, (n, 3)), ("grad_pc", grad_pc, (n, 3)),
              ("opt_positions.mu", opt_positions.mu, (n, 3)),
              ("opt_positions.nu", opt_positions.nu, (n, 3))]
    if grad_feats_direct is not None:
        shapes.append(("grad_feats_direct", grad_feats_direct,
                       (n, NUM_FEATURES)))
    if grad_scale is not None:
        shapes += [("grad_scale", grad_scale, (NUM_FEATURES,)),
                   ("band_mask", band_mask, (NUM_FEATURES,))]
    for name, t, shape in shapes:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    named = [(name, t) for name, t, _ in shapes] + [
        ("loss_ok", loss_ok), ("opt_features.count", opt_features.count),
        ("opt_positions.count", opt_positions.count)]
    for name, t in named:
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on "
                             f"{feats.device}")
    if loss_ok.dtype != torch.bool or loss_ok.dim() != 0:
        raise ValueError(f"loss_ok must be a 0-d bool tensor, got "
                         f"{loss_ok.dtype} {tuple(loss_ok.shape)}")


def _aligned(t):
    """`t` contiguous and 16-byte aligned (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _group_args(group: AdamGroup, state: AdamState):
    """(the kernel's Group argument, the 0-d tensors it points to): the
    bias corrections and learning rate with adam_update's torch ops."""
    c = (state.count + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(group.b1, c)
    bc2 = 1.0 - torch.pow(group.b2, c)
    lr = group.learning_rate(state.count)
    keep = [bc1, bc2]   # the kernel reads these through raw pointers
    lr_ptr, lr_value = None, 0.0
    if isinstance(lr, torch.Tensor):
        if lr.dtype != torch.float32 or lr.device != c.device:
            raise ValueError(f"a scheduled learning rate must be float32 on "
                             f"{c.device}, got {lr.dtype} on {lr.device}")
        lr = lr.contiguous()
        keep.append(lr)
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)
    args = AdamGroupArgs(bc1.data_ptr(), bc2.data_ptr(), lr_ptr, lr_value,
                         1.0 - group.b1, group.b1, 1.0 - group.b2, group.b2,
                         group.eps)
    return args, keep


def optimizer_update(feats, grad_feats, pc, grad_pc,
                     opt_features: AdamState, opt_positions: AdamState,
                     features: AdamGroup, positions: AdamGroup, loss_ok,
                     grad_scale=None, band_mask=None,
                     grad_feats_direct=None) -> OptimizerUpdate:
    """One optimizer step of both groups (features (N, 56) at `features`,
    positions (N, 3) at `positions`) under the loss guard `loss_ok` (0-d
    bool).

    `feats` are the stored features, and the gradients are with respect to
    them with each quaternion's norm held constant, as the projection
    gives them. With `grad_scale` and `band_mask` (56,), `grad_feats` is
    the rasterizer path's raw gradient and the step's is
    `combine_feature_gradients(grad_feats, grad_scale, band_mask,
    grad_feats_direct)`; without them `grad_feats` is taken as it is (a
    batch step's sum). Then `normalize_quaternions`: Adam's parameter is
    q / |q| with the gradient with respect to it. Non-finite gradient rows
    are zeroed (`contain_gradients`); a non-finite loss leaves the features
    as they were with their quaternions normalized, the positions and
    moments as they were and the counts untaken.

    CPU tensors take `optimizer_update_torch`; CUDA tensors launch the
    kernel; any other device raises."""
    if (grad_scale is None) != (band_mask is None) or (
            grad_feats_direct is not None and grad_scale is None):
        raise ValueError("grad_scale and band_mask come together, and a "
                         "direct gradient only with them")
    _check(feats, grad_feats, pc, grad_pc, opt_features, opt_positions,
           loss_ok, grad_scale, band_mask, grad_feats_direct)
    if not on_card(feats, "optimizer_update"):
        return optimizer_update_torch(
            feats, grad_feats, pc, grad_pc, opt_features, opt_positions,
            features, positions, loss_ok, grad_scale, band_mask,
            grad_feats_direct)
    device = feats.device
    n = feats.shape[0]
    feats, grad_feats, mu_f, nu_f = (_aligned(t) for t in (
        feats, grad_feats, opt_features.mu, opt_features.nu))
    optional = [None if t is None else _aligned(t)
                for t in (grad_feats_direct, grad_scale, band_mask)]
    pc, grad_pc, mu_p, nu_p = (t.contiguous() for t in (
        pc, grad_pc, opt_positions.mu, opt_positions.nu))
    loss_ok = loss_ok.contiguous()
    args_f, keep_f = _group_args(features, opt_features)
    args_p, keep_p = _group_args(positions, opt_positions)
    out_feats, out_mu_f, out_nu_f = (torch.empty_like(t)
                                     for t in (feats, mu_f, nu_f))
    out_pc, out_mu_p, out_nu_p, out_grad_pc = (
        torch.empty_like(t) for t in (pc, mu_p, nu_p, grad_pc))
    nonfinite = torch.empty((), dtype=torch.int32, device=device)
    launch("optimizer_update", n, feats.data_ptr(), grad_feats.data_ptr(),
           *(None if t is None else t.data_ptr() for t in optional),
           mu_f.data_ptr(), nu_f.data_ptr(), pc.data_ptr(),
           grad_pc.data_ptr(), mu_p.data_ptr(), nu_p.data_ptr(), args_f,
           args_p, loss_ok.data_ptr(), out_feats.data_ptr(),
           out_mu_f.data_ptr(), out_nu_f.data_ptr(), out_pc.data_ptr(),
           out_mu_p.data_ptr(), out_nu_p.data_ptr(), out_grad_pc.data_ptr(),
           nonfinite.data_ptr(), device=device)
    counts = [torch.where(loss_ok, s.count + 1, s.count)
              for s in (opt_features, opt_positions)]
    return OptimizerUpdate(
        out_feats, out_pc, AdamState(out_mu_f, out_nu_f, counts[0]),
        AdamState(out_mu_p, out_nu_p, counts[1]), out_grad_pc, nonfinite)
