"""The loss and its gradients of one step (``train_step.loss_and_grads``:
the forward with every block recomputed, and the backward), in ms, timed on
the host's clock to a synchronised end on one more step after the window."""


def read(r):
    return r.records.get("loss_and_grads_ms")
