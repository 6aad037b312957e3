"""Catch and the transitions an actor builds from it, written plainly.

Catch (``ApexCatch-v0``): a ``grid x grid`` board rendered at ``scale``
pixels a cell into an 84x84x1 u8 frame, the ball at 255 and the paddle
(three cells wide, clipped at the walls) at 128 on the bottom row.  An
action moves the paddle (0 stay, 1 left, 2 right, clipped); the ball falls
one row a step; when it reaches the bottom row the step scores +1 if the
paddle's centre is within one cell of the ball, else -1, and a new ball
drops in a drawn column, until ``balls`` have fallen.  The episode's last
frame keeps the landed ball, and the next episode starts with the paddle
centred and a ball in a drawn column.

Transitions: an episode's frames are ``f_0`` (the reset frame) and
``f_{k+1}``, the frame after step ``k``.  Step ``k`` acted on the stack of
the four frames ending at ``f_k`` (oldest first, the reset frame repeated
before it).  Once ``n`` more steps exist, step ``k`` yields the n-step
return ``sum_i gamma**i r_{k+i}`` with discount ``gamma**n`` and the next
stack ending at ``f_{k+n}``; when the episode ends first, each step left
in the window yields its truncated return with discount 0 and its own
stack as the next stack.
"""

from __future__ import annotations

import numpy as np


class Catch:
    def __init__(self, grid: int = 21, pixels: int = 84, balls: int = 5):
        self.grid, self.pixels, self.balls = grid, pixels, balls
        self.scale = pixels // grid

    def fresh(self, column: int) -> tuple:
        return (self.grid // 2, int(column), 0, self.balls)

    def render(self, state: tuple) -> np.ndarray:
        paddle, bx, by, _ = state
        s, g = self.scale, self.grid
        img = np.zeros((self.pixels, self.pixels), np.uint8)
        img[by * s:by * s + s, bx * s:bx * s + s] = 255
        p0 = max(paddle - 1, 0) * s
        p1 = (min(paddle + 1, g - 1) + 1) * s
        img[(g - 1) * s:g * s, p0:p1] = 128
        return img

    def step(self, state: tuple, action: int, drop: int, reset: int):
        """``(state, final_frame, first_frame_of_next_or_None, reward,
        done)``; ``drop`` is the new ball's column within the episode,
        ``reset`` the next episode's."""
        paddle, bx, by, remaining = state
        g = self.grid
        paddle = min(max(paddle + (0, -1, 1)[int(action)], 0), g - 1)
        by += 1
        reward, done = 0.0, False
        if by == g - 1:
            reward = 1.0 if abs(bx - paddle) <= 1 else -1.0
            remaining -= 1
            if remaining == 0:
                done = True
            else:
                bx, by = int(drop), 0
        final = self.render((paddle, bx, by, remaining))
        if done:
            nxt = self.fresh(reset)
            return nxt, final, self.render(nxt), reward, True
        return (paddle, bx, by, remaining), final, None, reward, False


def stack(frames: list, end: int, s: int = 4) -> np.ndarray:
    """The ``s`` frames ending at episode frame ``end``, oldest first."""
    return np.stack([frames[max(end - i, 0)] for i in range(s - 1, -1, -1)])


def lane_transitions(env: Catch, state: tuple, steps, n: int,
                     gamma: float) -> tuple[list, list]:
    """Transitions of one lane from ``state`` over ``steps`` ``[(action,
    drop, reset)]``, in the order they are emitted; also the acting stack
    of every step.  A transition is ``(obs [4, H, W], action, return f32,
    discount f32, next [4, H, W])``."""
    frames = [env.render(state)]
    window, out, acting = [], [], []

    def emit(length: int, full: bool) -> None:
        k, a, _ = window[0]
        ret = sum((gamma ** i) * window[i][2] for i in range(length))
        if full:
            out.append((stack(frames, k), a, np.float32(ret),
                        np.float32(gamma ** n), stack(frames, k + n)))
        else:
            out.append((stack(frames, k), a, np.float32(ret),
                        np.float32(0.0), stack(frames, k)))

    for action, drop, reset in steps:
        k = len(frames) - 1
        acting.append(stack(frames, k))
        state, final, first, reward, done = env.step(state, action, drop,
                                                     reset)
        frames.append(final)
        window.append((k, int(action), reward))
        if len(window) == n + 1:
            emit(n, True)
            window.pop(0)
        if done:
            while window:
                emit(len(window), False)
                window.pop(0)
            frames = [first]
    return out, acting
