"""MB of card memory the run's last CUDA graph capture reserved (make_train_many's pool_mb)."""


def read(ctx):
    return ctx.run.pool_mb
