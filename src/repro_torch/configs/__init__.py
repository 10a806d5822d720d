"""Architecture configs of the port; importing this package populates the
registry: the paper's ``bc-rmat``, ``dlrm-rm2``, the five LMs
(``gemma-7b``, ``codeqwen1.5-7b``, ``deepseek-coder-33b``,
``granite-moe-1b-a400m``, ``llama4-maverick-400b-a17b``) and the four
GNNs (``gat-cora``, ``gin-tu``, ``graphcast``, ``meshgraphnet``)."""
from . import (  # noqa: F401
    bc_rmat,
    codeqwen15_7b,
    deepseek_coder_33b,
    dlrm_rm2,
    gat_cora,
    gemma_7b,
    gin_tu,
    granite_moe_1b_a400m,
    graphcast,
    llama4_maverick_400b_a17b,
    meshgraphnet,
)
from .base import (
    BC_SHAPES,
    DLRM_SHAPES,
    GNN_SHAPES,
    LM_SHAPES,
    BCArch,
    BCShape,
    DLRMArch,
    DLRMShape,
    GNNArch,
    GNNShape,
    LMArch,
    LMShape,
    MoESpec,
)
from .registry import ArchBundle, get_arch, list_archs

__all__ = ["ArchBundle", "get_arch", "list_archs", "MoESpec", "LMArch", "LMShape", "LM_SHAPES",
           "GNNArch", "GNNShape", "GNN_SHAPES", "DLRMArch", "DLRMShape", "DLRM_SHAPES",
           "BCArch", "BCShape", "BC_SHAPES"]
