"""Iterative PCRNet for point-cloud registration.

Counterpart of ``shwd_tpu/models/pcrnet.py``: PointNet features of the
template (computed once) and of the running source (per iteration) are
concatenated and pushed through a 2048-1024-1024-512-512-256-7 MLP head to
a pose-7d (quaternion + translation); poses compose across iterations.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops.quaternion import (
    convert2transformation, create_pose_7d, pose_translation, quat_to_matrix,
    quaternion_transform,
)
from .pointnet import PointLinear, PointNet, max_pool


class PCRNetOutput(NamedTuple):
    est_R: torch.Tensor              # (B, 3, 3) source -> template rotation
    est_t: torch.Tensor              # (B, 1, 3)
    est_T: torch.Tensor              # (B, 4, 4)
    r: torch.Tensor                  # feature residual (B, emb_dims)
    transformed_source: torch.Tensor


class PCRNet(nn.Module):
    HEAD_WIDTHS = (2048, 1024, 1024, 512, 512, 256, 7)

    def __init__(self, feature_model: PointNet | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.feature_model = feature_model or PointNet(generator=generator)
        widths = self.HEAD_WIDTHS
        self.head = nn.ModuleList(
            PointLinear(widths[i], widths[i + 1], generator)
            for i in range(len(widths) - 1))

    def _head(self, y: torch.Tensor) -> torch.Tensor:
        last = len(self.head) - 1
        for i, layer in enumerate(self.head):
            y = layer(y)
            if i < last:
                y = torch.relu(y)
        return y

    def _pose_iteration(self, template_feat, source, est_R, est_t):
        """One refinement step: the head's pose composed onto the running
        estimate, est_t = R_temp est_t + t_temp and est_R = R_temp est_R."""
        source_feat = max_pool(self.feature_model(source))
        y = torch.cat([template_feat, source_feat], dim=-1)
        pose_7d = create_pose_7d(self._head(y))

        est_R_temp = quat_to_matrix(pose_7d[..., :4])
        est_t_temp = pose_translation(pose_7d)[:, None, :]            # (B, 1, 3)

        est_t = torch.einsum("bij,bkj->bki", est_R_temp, est_t) + est_t_temp
        est_R = torch.einsum("bij,bjk->bik", est_R_temp, est_R)
        source = quaternion_transform(source, pose_7d)
        return est_R, est_t, source, source_feat

    def forward(self, template: torch.Tensor, source: torch.Tensor,
                iteration_num: int = 8) -> PCRNetOutput:
        """template, source: (B, N, 3)."""
        b = template.shape[0]
        kw = dict(dtype=template.dtype, device=template.device)
        est_R = torch.eye(3, **kw).expand(b, 3, 3)
        est_t = torch.zeros(b, 1, 3, **kw)
        template_feat = max_pool(self.feature_model(template))

        source_feat = template_feat
        for _ in range(iteration_num):
            est_R, est_t, source, source_feat = self._pose_iteration(
                template_feat, source, est_R, est_t)

        return PCRNetOutput(
            est_R=est_R,
            est_t=est_t,
            est_T=convert2transformation(est_R, est_t),
            r=template_feat - source_feat,
            transformed_source=source,
        )
