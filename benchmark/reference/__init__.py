"""The plain reference: a frozen copy of the port's plain PyTorch path
(engine, SPD solve, the pose task). It imports nothing of the program and reads each scene's ``.npz`` itself."""
