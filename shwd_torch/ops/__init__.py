"""Transport ops: costs, samplers, Sinkhorn, the auction, the exact oracle,
1-D and spherical sliced OT.

The CUDA kernels sit behind ``emd2_warmup`` (``sinkhorn_kernels``),
``auction_assignment`` (``auction``), ``sinkhorn_points``
(``sinkhorn_points``) and ``chamfer_tiled`` (``chamfer``).
"""

from .costs import (cost_matrix, cosine_cost, cosine_similarity,  # noqa: F401
                    geodesic_cost, lp_cost, sqeuclidean_cost)
from .sinkhorn import (emd2_approx, sinkhorn_divergence_cost,  # noqa: F401
                       sinkhorn_log, sinkhorn_loss)
from .sinkhorn_fused import (emd2_points, fused_supported,  # noqa: F401
                              sinkhorn_points, sinkhorn_points_reference)
from .chamfer import (chamfer, chamfer_directional, chamfer_tiled,  # noqa: F401
                      chamfer_tiled_reference)
from . import quaternion  # noqa: F401
from .sinkhorn_kernels import (emd2_warmup, emd2_warmup_reference,  # noqa: F401
                               warmup_supported)
from .auction import (auction_assignment, auction_assignment_reference,  # noqa: F401
                      auction_emd2, hybrid_assignment_warm, hybrid_emd2,
                      hybrid_warm_sentinel)
from .emd_exact import (emd2_exact, emd2_exact_batch, emd2_exact_torch,  # noqa: F401
                        w2_exact)
from .ot1d import (batched_searchsorted, circle_ot, emd1d,  # noqa: F401
                   emd1d_circle, emd1d_general)
from .spherical import (project_to_circle, sliced_cost_sphere,  # noqa: F401
                        sliced_wasserstein_sphere, stiefel_frames)
