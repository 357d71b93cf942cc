"""The plain reference that decides ``correct``: plain PyTorch in fp32,
independent of the program (it imports nothing of ``repro_torch``)."""
