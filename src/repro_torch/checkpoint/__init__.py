from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    load_train_state,
    restore,
    restore_train_state,
    save,
    train_state,
)
