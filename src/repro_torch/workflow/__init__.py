"""Workflow layer: DAGs of ML tasks (HPO / NAS / fine-tune / eval /
deploy / online-update) under one global deadline + budget on a shared
serverless fleet.

 - dag:          ``TaskSpec`` / ``WorkflowDAG`` — the typed task graph;
                 ``deploy`` tasks carry a ``ServingTask`` and run as
                 event-engine ``ServingJob``s on the shared domain
 - allocator:    ``BudgetAllocator`` — splits one ``Goal`` into per-task
                 grants, deadlines, and worker windows; re-allocates on
                 every completion
 - tuner:        ``HPOSweep`` / ``SuccessiveHalving`` — rung-structured
                 successive-halving HPO with warm-started rungs
 - orchestrator: ``WorkflowOrchestrator`` — co-schedules ready tasks as
                 concurrent ``TaskScheduler`` jobs on one shared
                 ``ContentionDomain``

The port's copy of the JAX package's ``workflow`` package (numpy only).
"""
from repro_torch.workflow.allocator import (  # noqa: F401
    BudgetAllocator, TaskAllocation, TaskForecast)
from repro_torch.workflow.dag import TaskSpec, WorkflowDAG  # noqa: F401
from repro_torch.workflow.orchestrator import (  # noqa: F401
    WorkflowOrchestrator, WorkflowResult)
from repro_torch.workflow.tuner import (  # noqa: F401
    HPOSweep, SuccessiveHalving, expand_hpo, sweep_final_tasks, trial_loss)
