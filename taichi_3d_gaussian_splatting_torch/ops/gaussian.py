"""Per-Gaussian feature layout and the constants the render keys off.

Feature-row layout of the (N, 56) feature table:
[0:4] quaternion xyzw, [4:7] log-scales, [7] alpha logit,
[8:24]/[24:40]/[40:56] R/G/B SH coefficients.
"""

# Feature layout slices
FEATURE_Q = slice(0, 4)
FEATURE_S = slice(4, 7)
FEATURE_ALPHA = 7
FEATURE_R_SH = slice(8, 24)
FEATURE_G_SH = slice(24, 40)
FEATURE_B_SH = slice(40, 56)
NUM_FEATURES = 56

# Low-pass filter added to the projected covariance diagonal so every
# Gaussian is at least ~1 pixel wide.
COV_LOW_PASS = 0.3

# The blend skips (and passes no gradient through) any per-pixel
# contribution below this. The blend kernel, its plain version and the
# projection's opacity-aware extent bound all key off this one constant.
ALPHA_SKIP_THRESHOLD = 1.0 / 255.0
