"""The ds2 model-epilogue experiments, ported to the card.

Counterparts of the experiment scripts whose Pallas kernels chose the TPU
design of the packed 2×2 downsample (``_ds2_pack_kernel``):

  exp_model_fusion2  the in-scan ds2 variants (A, E1, E2 and their NCHW and
                     packed forms); E1 runs csrc/kmv_compose.cu's fused
                     compose+ds2 instance, one launch a step
  exp_pallas_ds      the six ds2 layout variants (csrc/ds_probe.cu, and
                     csrc/ds2_pack.cu for tpose16)
  exp_pallas_ds2     three cost-isolation probes (csrc/ds_probe.cu)
  exp_pallas_bisect  seven Mosaic lowering probes (csrc/ds_probe.cu)

Each runs as ``python -m jsplayer_tpu_torch.experiments.<name>`` on one
CUDA card, holds every kernel against its plain twin (probes.py,
kernels/sp_recon.py, kernels/rgb_convert.py) and prints times beside the
card's name and power limit.  ``streams`` builds the bench-mix stream the
fusion experiment decodes; ``kmv_step`` times the two kmv kernels at a
B=4 random step, through the wrapper and as a CUDA graph; ``block_step``,
``bc_step``, ``probe_step`` and ``lane_step`` do the same for the
sp_motion.cu modes, bc_compose, the ds_probe modes that one PyTorch call
matches (block_transpose, passthru, hpair_i32, wpair_i32: each beside that
call) and the lane path's kernels (lane_compose and the two rANS decodes,
beside the chain probe's bound); ``lane_runs`` profiles the lane path's
runs (h) and (j); ``consumer_step`` times packed_consumer_step at
ViT-B/16's patch embed on a 64-frame 1080p window beside ds2_pack (and
one cuDNN convolution as the patch embed's yardstick).
Nothing here imports jax.
"""
