"""AdamW's update of one step (``optimizer.adamw_update``, eager), in ms,
timed on the host's clock to a synchronised end on the same step as
``loss_and_grads_ms.train``."""


def read(r):
    return r.records.get("adamw_ms")
