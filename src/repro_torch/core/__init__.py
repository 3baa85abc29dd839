"""Colmena core: the paper's contribution as a composable library.

Thinker (multi-agent steering policies) <-> Task Server (dispatch, retry,
straggler mitigation) <-> Workers, with per-topic queues, a Value Server
for large-object transfer, pooled resource tracking, and the abstract
campaign formulation of §II-A.
"""
from repro_torch.core.campaign import (AssaySpec, CampaignRecord,  # noqa: F401
                                 Observation, checkpoint_campaign,
                                 resume_campaign)
from repro_torch.core.cluster import (ClusterLauncher, ClusterSpec,  # noqa: F401
                                HostSpec)
from repro_torch.core import policies  # noqa: F401
from repro_torch.core.message import Intermediate, Result, Task  # noqa: F401
from repro_torch.core.process_pool import ProcessPoolTaskServer  # noqa: F401
from repro_torch.core.queues import ColmenaQueues  # noqa: F401
from repro_torch.core.resources import ResourceTracker  # noqa: F401
from repro_torch.core.streaming import (TaskCancelled,  # noqa: F401
                                  report_intermediate)
from repro_torch.core.task_server import TaskServer  # noqa: F401
from repro_torch.core.thinker import (BaseThinker, agent, event_responder,  # noqa: F401
                                result_processor)
from repro_torch.core.transport.shards import ShardedValueServer  # noqa: F401
from repro_torch.core.value_server import Proxy, ValueServer  # noqa: F401
