"""The contribution bus: the port of `katacoffee_tpu/distributed/`, an HTTP
task, model and data bus (stdlib HTTP, JSON and npz bodies) that writes into
the base-dir layout the loop uses, so contributed data flows into shuffle
and train unchanged."""

from katacoffee_tpu_torch.distributed.client import ContributeClient
from katacoffee_tpu_torch.distributed.server import ContributionServer

__all__ = ["ContributeClient", "ContributionServer"]
