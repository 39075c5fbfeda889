"""The TPU probes under scratch/ (variants of the forward blend, the cost of
its instruction mixes, the semantics its scans assume) as hand-written
Hopper kernels (csrc/probes/) with their plain versions. One module per
probe, named after its scratch file:

- ``perf_rgb_ablate2`` (S4): K1 with its stages stripped in turn;
- ``perf_exp2_probe`` (S1): the exponent by exp, exp2 after a multiply,
  exp2 on prescaled rows;
- ``perf_kernel_ablate`` (S3): one stage removed at a time on a synthetic
  layout;
- ``perf_flip_proto`` (S2): keys by pixels, the exponent on the tensor
  cores;
- ``perf_roll_micro`` (S5): a shuffle doubling scan, a shared-memory scan,
  exp, a multiply chain and an FP64 tensor-core product, each repeated 300
  times on a block kept on chip;
- ``roll_semantics_check`` (S6): the roll and the doubling scans by warp
  shuffles, and the blend kernels' work-list scan, held bitwise against
  their plain versions (it exits 1 on a mismatch).

Each runs as ``python -m taichi_3d_gaussian_splatting_torch.probes.<name>``
on a card and prints one JSON line per mode (S6 per plane and scan draw).
"""
