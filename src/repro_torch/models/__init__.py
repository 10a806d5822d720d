"""Models of the port (so far DLRM, the recsys substrate)."""
from .dlrm import DLRM, dlrm_loss, embedding_bag_lookup, retrieval_scores

__all__ = ["DLRM", "embedding_bag_lookup", "dlrm_loss", "retrieval_scores"]
