from ltm_torch.utils.logging import (  # noqa: F401
    count_slots,
    current_stage,
    get_logger,
    reset_slot_counts,
    reset_stage_times,
    slot_counts,
    stage_timer,
    stage_times,
)
