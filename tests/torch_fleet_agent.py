"""Entry points of the port's worker processes that the fleet tests start
with ``spawn``.

A spawned child imports the module of its target. This module imports the
port alone, never JAX or the JAX package, so a child loads only what a
worker started as ``python -m s3shuffle_tpu_torch.worker`` would load.
"""

import os


def agent_main(coordinator, cfg_dict, worker_id, heartbeat_s=0.5, device="cpu", env=None):
    """One ``WorkerAgent`` on ``device`` until it is drained or stopped.
    ``env`` sets environment variables first (the tracer and the registry
    read theirs at import)."""
    os.environ.update(env or {})
    from s3shuffle_tpu_torch.config import ShuffleConfig
    from s3shuffle_tpu_torch.storage.dispatcher import Dispatcher
    from s3shuffle_tpu_torch.worker import WorkerAgent

    Dispatcher.reset()
    agent = WorkerAgent(tuple(coordinator), config=ShuffleConfig(**cfg_dict),
                        worker_id=worker_id, device=device)
    try:
        agent.run_forever(poll_interval=0.01, heartbeat_s=heartbeat_s)
    finally:
        agent.client.close()
