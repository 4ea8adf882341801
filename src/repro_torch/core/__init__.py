# ExpoCloud — the paper's contribution, reproduced and grown:
#   space.py / experiment.py — declarative ParamSpace + @task + the
#                              one-call Experiment facade (RunHandle
#                              streams typed RunEvents)
#   engines.py               — name -> engine factory registry
#   task.py / hardness.py    — AbstractTask, hardness partial order, min_hard
#   scheduler.py / policy.py — pure SchedulerCore + pluggable policies
#   server.py / client.py    — pull-model primary/backup protocol shell
#   engine.py                — create/terminate/list engine abstraction
#   sim.py                   — deterministic virtual-clock cloud simulator
#   sweep.py                 — ML-cell bridge (arch x shape x mesh tasks)
from repro_torch.core import engines
from repro_torch.core.engine import (AbstractEngine, EngineUnavailable, GCEEngine,
                               LocalEngine, RateLimited, TPUPodEngine)
from repro_torch.core.experiment import (CostTick, Experiment, InstanceCreated,
                                   InstancePreempted, InstanceTerminated,
                                   KillPrimary, Partition, RunDone, RunEvent,
                                   RunHandle, SpotWave, TaskPruned,
                                   TaskSolved, TaskTimedOut)
from repro_torch.core.hardness import Hardness, MinHardSet
from repro_torch.core.messages import Message, MsgType
from repro_torch.core.policy import (AssignPolicy, BudgetPolicy, CostMeter,
                               ScalePolicy)
from repro_torch.core.results import ResultsTable
from repro_torch.core.server import Server, ServerConfig
from repro_torch.core.shard import (ShardCoordinator, merge_cost_summaries,
                              merge_results, partition_tasks, pump_gossip)
from repro_torch.core.sim import (InstanceType, ShardedSimCluster, SimCluster,
                            SimParams, SimTask)
from repro_torch.core.space import Axis, ParamSpace, axis, task
from repro_torch.core.task import AbstractTask

__all__ = [
    # unified experiment API (the front door)
    "Experiment", "RunHandle", "ParamSpace", "Axis", "axis", "task",
    "engines",
    # typed run events + chaos directives
    "RunEvent", "TaskSolved", "TaskPruned", "TaskTimedOut",
    "InstanceCreated", "InstanceTerminated", "InstancePreempted",
    "CostTick", "RunDone", "SpotWave", "Partition", "KillPrimary",
    # tasks / hardness / results
    "AbstractTask", "Hardness", "MinHardSet", "ResultsTable",
    # engines
    "AbstractEngine", "LocalEngine", "GCEEngine", "TPUPodEngine",
    "RateLimited", "EngineUnavailable",
    # simulator + server stack (advanced / deprecated direct wiring)
    "SimCluster", "ShardedSimCluster", "SimParams", "SimTask",
    "InstanceType", "Server", "ServerConfig", "Message", "MsgType",
    # sharded hierarchical scheduling (core.shard)
    "ShardCoordinator", "partition_tasks", "pump_gossip",
    "merge_results", "merge_cost_summaries",
    # policies + cost
    "AssignPolicy", "ScalePolicy", "BudgetPolicy", "CostMeter",
]
