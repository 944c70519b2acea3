"""dwpa_tpu_torch — the m22000 cracking path on PyTorch and CUDA.

A second implementation of ``dwpa_tpu`` for an NVIDIA Hopper GPU, module
for module (the names and layout mirror the JAX package so each module's
counterpart is easy to find):

- ``dwpa_tpu_torch.ops``      — SHA-1, MD5, SHA-256, HMAC, AES-128-CMAC
  and PBKDF2 as batched int32 torch ops, plus the hand-written
  PBKDF2-HMAC-SHA1 CUDA kernel (``ops/pbkdf2_cuda.py``,
  ``csrc/pbkdf2_sha1.cu``).
- ``dwpa_tpu_torch.models``   — hashline parsing and the m22000 engine.
- ``dwpa_tpu_torch.parallel`` — device selection and the crack step.
- ``dwpa_tpu_torch.oracle``   — the hashlib verification oracle.
- ``dwpa_tpu_torch.native``   — the C++ candidate packer and capture
  parser (ctypes).
- ``dwpa_tpu_torch.gen``      — dictionary streams and candidate generators.
- ``dwpa_tpu_torch.feed``     — block framing, the threaded candidate feed
  and the CUDA side-stream stager.
- ``dwpa_tpu_torch.obs``      — metrics, spans and logging.
- ``dwpa_tpu_torch.client``   — the volunteer client: challenge gate,
  transport, found outbox, the get_work -> crack -> put_work loop and its
  CLI (``python -m dwpa_tpu_torch.client``).
- ``dwpa_tpu_torch.server``   — the work server, its pre-crack and its
  operator tools (``python -m dwpa_tpu_torch.server``).
- ``dwpa_tpu_torch.chaos``    — seeded fault injection for the transport,
  the server's database and the filesystem.

32-bit words travel as ``torch.int32`` (addition wraps; logical right
shifts mask off the sign fill); they are reinterpreted as uint32 only at
the numpy boundary.  Every entry point takes a ``device``; the default is
``cuda:0`` and there is no silent CPU fallback.
"""

__version__ = "0.1.0"
