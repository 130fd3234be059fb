"""The W8A8 conv geometries shared by the card test
(``tests/test_torch_port_cuda.py``) and the CPU test of the kernels' weight
layout (``tests/test_torch_quantize.py``).

name -> x shape, weight shape, stride, padding, groups: the zoo's eligible
geometries (EDSR 3x3, DRF's k6 s2 and 1x1 squeeze, DUF's and the volumes'
3D convs), shapes off the patch kernel's tiles (128-pixel output boxes, N
tiles of 32 / 64 / 128, 32-deep K steps), its weights streamed with each
chunk (``stream_3d``, ``stream_n128``), and the gather kernel, the general
path (``k5_ragged``: 25 taps of an N tile of 128 fit no stage;
``gather_k16s8``: the patch of a 16 x 16 kernel at stride 8 fits none)."""

W8A8_CASES = {
    "k3_64": ((2, 64, 20, 24), (64, 64, 3, 3), (1, 1), (1, 1), 1),
    "k6s2": ((3, 64, 24, 24), (64, 64, 6, 6), (2, 2), (2, 2), 1),
    "k1": ((2, 96, 9, 13), (64, 96, 1, 1), (1, 1), (0, 0), 1),
    "k5_ragged": ((5, 70, 13, 17), (130, 70, 5, 5), (1, 1), (2, 2), 1),
    "groups4": ((2, 16, 12, 12), (32, 4, 3, 3), (1, 1), (1, 1), 4),
    "conv3d": ((2, 16, 4, 8, 8), (32, 16, 3, 3, 3), (1, 1, 1), (1, 1, 1), 1),
    "conv3d_133": ((2, 64, 7, 20, 20), (48, 64, 1, 3, 3), (1, 1, 1),
                   (0, 1, 1), 1),
    # The N tile templates: F = 32 and F = 256 (two tiles of 128).
    "f32": ((2, 64, 20, 24), (32, 64, 3, 3), (1, 1), (1, 1), 1),
    "f256": ((1, 64, 18, 40), (256, 64, 3, 3), (1, 1), (1, 1), 1),
    # C = 16, padded to the 32-deep K step.
    "c16": ((2, 16, 17, 23), (64, 16, 3, 3), (1, 1), (1, 1), 1),
    # Outputs off the spatial tile along y and x.
    "tile_ragged": ((3, 48, 13, 37), (64, 48, 3, 3), (1, 1), (1, 1), 1),
    # Stride 2 on an odd input.
    "s2_odd": ((2, 32, 23, 31), (48, 32, 3, 3), (2, 2), (1, 1), 1),
    # 3D inputs of depth 1 and 7.
    "d1_3d": ((2, 64, 1, 20, 24), (32, 64, 1, 3, 3), (1, 1, 1), (0, 1, 1),
              1),
    "d7_3d": ((1, 64, 7, 16, 20), (32, 64, 3, 3, 3), (1, 1, 1), (1, 1, 1),
              1),
    # Weights too large to stay: streamed with each chunk (N tiles of 32
    # and 128).
    "stream_3d": ((1, 224, 3, 12, 16), (32, 224, 3, 3, 3), (1, 1, 1),
                  (0, 1, 1), 1),
    "stream_n128": ((1, 256, 1, 12, 20), (256, 256, 1, 3, 3), (1, 1, 1),
                    (0, 1, 1), 1),
    # A patch too large for shared memory: the gather kernel.
    "gather_k16s8": ((1, 32, 40, 40), (32, 32, 16, 16), (8, 8), (0, 0), 1),
}
