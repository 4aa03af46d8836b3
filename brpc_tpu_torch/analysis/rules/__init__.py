"""graftlint rule registry."""

from __future__ import annotations

from typing import List

from brpc_tpu_torch.analysis.core import Rule


def default_rules() -> List[Rule]:
    from brpc_tpu_torch.analysis.rules.block_recycle import BlockRecycleRule
    from brpc_tpu_torch.analysis.rules.event_wait import EventWaitNotSleepRule
    from brpc_tpu_torch.analysis.rules.fiber_blocking import FiberBlockingRule
    from brpc_tpu_torch.analysis.rules.guarded_by import GuardedByRule
    from brpc_tpu_torch.analysis.rules.iobuf_aliasing import IOBufAliasingRule
    from brpc_tpu_torch.analysis.rules.judge_defer import JudgeDeferRule
    from brpc_tpu_torch.analysis.rules.lock_graph import (
        BlockingUnderLockRule, CallbackUnderLockRule, LockCycleRule,
    )
    from brpc_tpu_torch.analysis.rules.memoryview_release import (
        MemoryviewReleaseRule,
    )
    from brpc_tpu_torch.analysis.rules.postfork_reset import PostforkResetRule
    from brpc_tpu_torch.analysis.rules.registry_complete import (
        RegistryCompleteRule,
    )
    from brpc_tpu_torch.analysis.rules.sampler_import import (
        SamplerNoLazyImportRule,
    )
    from brpc_tpu_torch.analysis.rules.span_finish import SpanFinishRule
    return [BlockRecycleRule(), BlockingUnderLockRule(),
            CallbackUnderLockRule(), EventWaitNotSleepRule(),
            FiberBlockingRule(), GuardedByRule(),
            IOBufAliasingRule(), JudgeDeferRule(),
            LockCycleRule(), MemoryviewReleaseRule(),
            PostforkResetRule(), RegistryCompleteRule(),
            SamplerNoLazyImportRule(), SpanFinishRule()]
