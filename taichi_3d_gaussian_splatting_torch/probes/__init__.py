"""K1 ablation probes: the TPU probes under scratch/ that timed variants of
the forward blend, as hand-written Hopper kernels (csrc/probes/) with their
plain versions. One module per probe, named after its scratch file:

- ``perf_rgb_ablate2`` (S4): K1 with its stages stripped in turn;
- ``perf_exp2_probe`` (S1): the exponent by exp, exp2 after a multiply,
  exp2 on prescaled rows;
- ``perf_kernel_ablate`` (S3): one stage removed at a time on a synthetic
  layout;
- ``perf_flip_proto`` (S2): keys by pixels, the exponent on the tensor
  cores.

Each runs as ``python -m taichi_3d_gaussian_splatting_torch.probes.<name>``
on a card and prints one JSON line per mode.
"""
