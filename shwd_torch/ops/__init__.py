"""Transport ops: costs, samplers, Sinkhorn, the auction and the exact oracle.

The two CUDA kernels of this slice sit behind ``emd2_warmup``
(``sinkhorn_kernels``) and ``auction_assignment`` (``auction``).
"""

from .costs import (cost_matrix, cosine_cost, cosine_similarity,  # noqa: F401
                    geodesic_cost, lp_cost, sqeuclidean_cost)
from .sinkhorn import emd2_approx, sinkhorn_log  # noqa: F401
from .sinkhorn_kernels import (emd2_warmup, emd2_warmup_reference,  # noqa: F401
                               warmup_supported)
from .auction import (auction_assignment, auction_assignment_reference,  # noqa: F401
                      auction_emd2, hybrid_assignment_warm, hybrid_emd2,
                      hybrid_warm_sentinel)
from .emd_exact import emd2_exact, emd2_exact_batch, w2_exact  # noqa: F401
