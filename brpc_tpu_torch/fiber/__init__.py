"""M:N fiber runtime of the port (brpc_tpu/fiber/, bRPC's bthread):
worker threads stepping coroutines, butex-based sync, a timer thread,
the ExecutionQueue and fiber-locals, the WorkerModule hook through
which the serving engine's decode slices run on the workers, and the
DeviceEventPoller, on which a fiber parks until a CUDA event or a future
is ready (``await device_ready(ev)``)."""

from .butex import WAIT_OK, WAIT_TIMEOUT, WAIT_VALUE_CHANGED, Butex
from .device_poller import DeviceEventPoller, device_ready, global_poller
from .execution_queue import ExecutionQueue
from .keys import FiberLocal
from .scheduler import (Fiber, SchedAwaitable, TaskControl, TaskGroup,
                        current_fiber, current_group, global_control,
                        set_concurrency, spawn, spawn_urgent, yield_now)
from .sync import CountdownEvent, FiberCondition, FiberEvent, FiberMutex
from .timer import PeriodicTask, TimerThread, global_timer, sleep, sleep_us

__all__ = [
    "Fiber", "TaskControl", "TaskGroup", "SchedAwaitable", "current_fiber",
    "current_group", "global_control", "set_concurrency", "spawn",
    "spawn_urgent", "yield_now",
    "Butex", "WAIT_OK", "WAIT_TIMEOUT", "WAIT_VALUE_CHANGED",
    "CountdownEvent", "FiberCondition", "FiberEvent", "FiberMutex",
    "PeriodicTask", "TimerThread", "global_timer", "sleep", "sleep_us",
    "ExecutionQueue", "DeviceEventPoller", "device_ready", "global_poller",
    "FiberLocal",
]
