"""The norms' shapes on the request path, at the configuration's widths
(`benchmark/configs/stableanimator-svdxt-infer.json`): every GroupNorm
(N, rows, C) and LayerNorm (rows, C) that a 16-frame request at 512 x 512
and at 576 x 1024 calls in its UNet (CFG batch 2 x 16 frames), its VAE
decoder (16 frames at once at 512 x 512, chunks of 4 at 576 x 1024) and its
conditioning, as chip_smoke.py's generate and pro phases count their
launches on the card. JAX-free.
"""

# (N, rows, C): N 32 for the spatial norms (a sample a frame), 2 for the
# UNet's temporal norms (a sample a video), 16 / 4 for the decoder's
# spatial norms, 4 / 1 for its temporal ones (a sample a 4-frame chunk)
GROUP_NORM_SHAPES = sorted({
    # UNet, 512 x 512
    (2, 1024, 1280), (2, 16384, 640), (2, 4096, 1280), (2, 65536, 320),
    (32, 1024, 1280), (32, 1024, 1920), (32, 1024, 320), (32, 1024, 640), (32, 1024, 960),
    (32, 256, 1280), (32, 256, 1920), (32, 256, 2560), (32, 256, 640),
    (32, 4096, 320), (32, 4096, 640), (32, 4096, 960), (32, 64, 1280), (32, 64, 2560),
    # UNet, 576 x 1024
    (2, 147456, 320), (2, 2304, 1280), (2, 36864, 640), (2, 9216, 1280),
    (32, 144, 1280), (32, 144, 2560), (32, 2304, 1280), (32, 2304, 1920), (32, 2304, 320),
    (32, 2304, 640), (32, 2304, 960), (32, 576, 1280), (32, 576, 1920), (32, 576, 2560),
    (32, 576, 640), (32, 9216, 320), (32, 9216, 640), (32, 9216, 960),
    # VAE decoder, 512 x 512 (16 frames; the temporal norms' 4-frame chunks
    # stacked on N)
    (4, 262144, 256), (4, 65536, 512), (4, 1048576, 128), (4, 16384, 512),
    (16, 16384, 512), (16, 262144, 128), (16, 262144, 256), (16, 4096, 512),
    (16, 65536, 256), (16, 65536, 512),
    # VAE decoder, 576 x 1024 (4 frames a chunk)
    (1, 147456, 512), (1, 2359296, 128), (1, 36864, 512), (1, 589824, 256),
    (4, 147456, 256), (4, 147456, 512), (4, 36864, 512), (4, 589824, 128), (4, 589824, 256),
    (4, 9216, 512),
})

# (rows, C): the UNet's transformer blocks at both sizes; the conditioning's
# CLIP (257 tokens and the pooled one at width 1280) and face encoder (4
# tokens and one at width 1024)
LAYER_NORM_SHAPES = sorted({
    (131072, 320), (32768, 640), (8192, 1280), (2048, 1280),
    (294912, 320), (73728, 640), (18432, 1280), (4608, 1280),
    (257, 1280), (1, 1280), (4, 1024), (1, 1024),
})
