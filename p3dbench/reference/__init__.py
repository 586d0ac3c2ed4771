"""The plain references that decide ``correct``: plain PyTorch written
from the configurations' stated semantics, importing nothing of the
measured program and taking nothing it made."""
