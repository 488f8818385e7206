"""Decoupled curvature service: the refresh off the training step.

Port of ``kfac_pytorch_tpu/service/``. Every other lever (chunks, overlap,
slip, rsvd, streaming) shrinks or hides the curvature refresh inside the
training step; this package removes it. A worker (a thread on its own CUDA
stream, or trailing ranks carved from the world by
``parallel.mesh.service_world``) runs the eigen refresh on published
factor snapshots and publishes the bases back at bounded staleness, so the
training steps hold only capture, precondition and apply.

Roles and flow::

    trainer                                  worker
    -------                                  ------
    step, EMA factors
    publish factors v ---[factors mailbox]---> refresh (eigh/rsvd)
    install basis v  <----[basis mailbox]----- publish basis v
    step, step, ...

Enable with ``KFAC(service_devices=N, ...)``: ``update`` then refuses
every refresh flag, which is what keeps the training step free of
eigendecompositions.
"""

from kfac_pytorch_tpu_torch.parallel.mesh import split_service_mesh
from kfac_pytorch_tpu_torch.service.client import CurvatureService, ServiceClient
from kfac_pytorch_tpu_torch.service.mailbox import DeviceMailbox, HostMailbox
from kfac_pytorch_tpu_torch.service.worker import SCALARS_KEY, CurvatureWorker

__all__ = [
    "CurvatureService",
    "CurvatureWorker",
    "DeviceMailbox",
    "HostMailbox",
    "SCALARS_KEY",
    "ServiceClient",
    "split_service_mesh",
]
