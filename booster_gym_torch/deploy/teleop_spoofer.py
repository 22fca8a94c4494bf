"""Standalone WebSocket server emitting mock upper-body joint targets.

Test double for the VR tracking server (reference:
deploy/websocket_spoofer.py): emits {"target_positions": [...]} for the 10
upper-body joints at a fixed rate in sine / random / fixed mode so the
teleop reception path can be exercised without hardware.

Usage: python -m booster_gym_torch.deploy.teleop_spoofer [--mode sine]
"""

import argparse
import json
import logging
import time

import numpy as np

from booster_gym_torch.deploy.teleop import UPPER_BODY_LIMITS, clip_upper_body

logger = logging.getLogger(__name__)


class JointTargetGenerator:
    def __init__(self, mode="sine", amplitude=0.3, freq_hz=0.2, seed=0):
        self.mode = mode
        self.amplitude = amplitude
        self.freq_hz = freq_hz
        self.rng = np.random.default_rng(seed)
        mid = UPPER_BODY_LIMITS.mean(axis=-1)
        self.base = mid.astype(np.float32)

    def positions_at(self, t):
        if self.mode == "sine":
            phase = 2 * np.pi * self.freq_hz * t
            offsets = self.amplitude * np.sin(phase + np.arange(10) * 0.3)
            return clip_upper_body(self.base + offsets)
        if self.mode == "random":
            return clip_upper_body(self.base + self.rng.normal(0, 0.1, 10))
        return clip_upper_body(self.base)


async def serve(host="localhost", port=8765, mode="sine", rate_hz=100.0):
    import asyncio

    import websockets

    gen = JointTargetGenerator(mode=mode)
    t0 = time.time()

    async def handler(ws):
        logger.info("teleop client connected")
        try:
            while True:
                targets = gen.positions_at(time.time() - t0)
                await ws.send(json.dumps({"target_positions": targets.tolist()}))
                try:
                    raw = await asyncio.wait_for(ws.recv(), timeout=0.0005)
                    msg = json.loads(raw)
                    if "observed_positions" in msg:
                        logger.debug("observed: %s", msg["observed_positions"])
                except (asyncio.TimeoutError, TimeoutError):
                    pass
                await asyncio.sleep(1.0 / rate_hz)
        except Exception as e:
            logger.info("client disconnected: %s", e)

    async with websockets.serve(handler, host, port):
        await asyncio.Future()


if __name__ == "__main__":
    import asyncio

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--mode", default="sine", choices=["sine", "random", "fixed"])
    parser.add_argument("--rate", type=float, default=100.0)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    asyncio.run(serve(args.host, args.port, args.mode, args.rate))
