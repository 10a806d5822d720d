"""Models of the port: DLRM (the recsys substrate) and the decoder-only
LM (dense or MoE) with its attention, MoE and shared layers."""
from .attention import causal_attention, decode_attention
from .dlrm import DLRM, dlrm_loss, embedding_bag_lookup, retrieval_scores
from .layers import ACTIVATIONS, geglu, rms_norm, rope, swiglu
from .moe import moe_ffn
from .transformer import TransformerLM, cache_specs, padded_vocab, param_specs

__all__ = ["DLRM", "embedding_bag_lookup", "dlrm_loss", "retrieval_scores",
           "TransformerLM", "padded_vocab", "param_specs", "cache_specs",
           "causal_attention", "decode_attention", "moe_ffn",
           "rms_norm", "rope", "swiglu", "geglu", "ACTIVATIONS"]
