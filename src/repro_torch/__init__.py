"""PyTorch/CUDA port of the CSV semantic filter (the ``repro`` package is
the JAX reference it is tested against).

Module paths mirror the reference: ``repro/core/voting.py`` becomes
``repro_torch/core/voting.py`` with the same public names.  Entry points
take ``device=`` (default ``"cuda"``) and raise when no GPU is present
unless the caller passes ``device="cpu"``.
"""
import torch

# float32 products stay full float32 on the card: TF32 would keep about
# three decimal digits and break parity with the float32 reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
