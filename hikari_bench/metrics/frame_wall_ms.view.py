"""The viewer's wall time a frame, in ms (host clock): the window's seconds
over its frames. The host paces this cell, and its runs spread too widely
for any bound the benchmark may set, so it stands here and gpu_frame_ms
stands end to end."""


def read(ctx):
    win = ctx.window
    return 1e3 * win.seconds / win.frames if win.frames else None
