"""PyTorch / CUDA port of the serving path of the ``repro`` package.

The port mirrors ``repro``'s layout (``configs/``, ``models/``,
``kernels/``, ``launch/``) and imports nothing from it: the reference
package stays the oracle its tests compare against. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every
hand-written kernel is replaced by its plain PyTorch version."""
