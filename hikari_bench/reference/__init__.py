"""The benchmark's plain reference: a frozen copy of the port's PyTorch
code as it stood when the benchmark was defined (the render passes, the
train step's forward, the scene compile and the searches), with every
hand-written kernel replaced by its plain PyTorch twin on every device.

It imports nothing of the port, so a later change to the port leaves it
as it is. Its docstrings are the port's, copied whole; where one speaks of
a kernel launch, the copy runs the twin instead. The scene compile is the
port's C++ SAH builder, copied too (``scene/native``): the triangle order
follows the builder, and the frame's random light choices follow the
triangle order, so an independent builder would render other samples.
"""

import torch as _torch

# As the port: no TF32 in geometry or matmuls.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
