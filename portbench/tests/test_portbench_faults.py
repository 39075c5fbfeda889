"""A run with the timed path broken underneath comes out not correct,
once for each fault its cell can have: a training step that returns its
state unchanged; half of the view's rows left out of the loss, the mean
taken over the rest; a frame's image altered where it is produced; and,
on the uniform recipe of the 430k scenes, the view direction reversed in
the projection's SH evaluation. (No cell exchanges anything between
chips.) Tiny cells on the CPU, the card's check skipped."""

from helpers import run_tiny


def test_sound_runs_are_correct():
    for cell in ("tiny-render", "tiny-uniform-render", "tiny-train"):
        rc, line, _ = run_tiny(cell)
        assert rc == 0 and line["correct"] is True


def test_step_returning_its_state_unchanged(monkeypatch):
    from taichi_3d_gaussian_splatting_torch.training.trainer import (
        GaussianPointCloudTrainer as T)
    step = T.step

    def unchanged(self, *a, **k):
        kept = (self.scene, self.opt_features, self.opt_positions,
                self.ctrl_state)
        out = step(self, *a, **k)
        (self.scene, self.opt_features, self.opt_positions,
         self.ctrl_state) = kept
        return out

    monkeypatch.setattr(T, "step", unchanged)
    rc, line, _ = run_tiny("tiny-train")
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["change_gap"]["value"] > 0.5


def test_half_of_the_batch_left_out(monkeypatch):
    from taichi_3d_gaussian_splatting_torch.training.loss import LossFunction
    call = LossFunction.__call__

    def half(self, pred, gt, **kw):
        rows = pred.shape[0] // 2
        return call(self, pred[:rows], gt[:rows], **kw)

    monkeypatch.setattr(LossFunction, "__call__", half)
    rc, line, _ = run_tiny("tiny-train")
    assert rc == 0 and line["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from taichi_3d_gaussian_splatting_torch.ops import rasterizer
    rasterize = rasterizer.rasterize

    def altered(*a, **k):
        r = rasterize(*a, **k)
        image = r.image.clone()
        image[5, 7, 1] += 0.25
        return r._replace(image=image)

    monkeypatch.setattr(rasterizer, "rasterize", altered)
    rc, line, _ = run_tiny("tiny-render")
    assert rc == 0 and line["correct"] is False


def test_sh_bands_evaluated_wrong(monkeypatch):
    """The view direction reversed in the SH evaluation: bands 1 and 3
    change sign."""
    from taichi_3d_gaussian_splatting_torch.ops import projection
    basis = projection._sh_basis

    def flipped(x, y, z):
        b = basis(x, y, z)
        return b[:1] + [-f for f in b[1:4]] + b[4:9] + [-f for f in b[9:]]

    monkeypatch.setattr(projection, "_sh_basis", flipped)
    rc, line, _ = run_tiny("tiny-uniform-render")
    assert rc == 0 and line["correct"] is False
