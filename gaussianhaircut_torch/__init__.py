"""PyTorch / CUDA port of ``gaussianhaircut_tpu`` for NVIDIA Hopper (sm_90a).

The package mirrors the JAX package's layout (``ops/``, ``ops/rasterize/``,
``models/``, ``scene/``, ``render/``, ``train/``) so each module's
counterpart sits at the same path.  It imports torch only: nothing of JAX and
nothing of ``gaussianhaircut_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU device they raise (see ``device.resolve_device``).

TF32 is switched off for matmuls and cuDNN: ``ops/ssim.py`` blurs with
band-matrix products whose results must stay float32-exact.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
