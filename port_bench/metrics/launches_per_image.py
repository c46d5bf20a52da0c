"""Device operations (kernels, copies, memsets) in the traced window per
image answered."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.images:
        return None
    return t.count() / ctx.images
