"""Device ops: boundary max pooling (CUDA kernel + plain version), the
stem pack and soft-NMS.

Importing this package registers the kernels' `torch.library` custom ops
(`opental::boundary_max_pool_fwd`, `opental::boundary_max_pool_bwd`,
`opental::stem_pack96`, `opental::stem_pack96_v2`), which a program
saved by `tools/export.py` names."""

from opental_torch.ops import boundary_pool_cuda, stem_pack_cuda  # noqa: F401
