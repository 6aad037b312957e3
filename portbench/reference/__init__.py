"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy in float32 with TF32 off: the dueling
Q-network, the n-step double-DQN loss, global-norm clip and centered
RMSprop, the sum/min priority trees with the stratified sample, replay
rebuilt from the chunk messages, and Catch with the transitions an actor
builds from it, replayed from the env seeds and the actors' draws.
It imports neither the port nor JAX; it is written from the published
descriptions and the port's documented semantics, and frozen here.
"""
