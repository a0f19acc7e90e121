"""The reference's control-loop script on the PyTorch/CUDA engine.

The counterpart of ``examples/jde_robots_main.py`` on
``fastslam_tpu_torch``'s exported names: the reference's
``jde_robots_main.py`` (pasted into the JdeRobot simulator's web UI) runs
here against the built-in synthetic world, or any other Driver, with only
the reference-compatible names, so a reference user can switch imports and
keep their program's structure.  The filter, the frontend and the landmark
clustering run on ``--device`` (default cuda; without a card that stops
with an error).

Run:  python examples/jde_robots_main_torch.py [--ticks 400] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from fastslam_tpu_torch import (
    EvaluationUtils,
    FastSLAM2,
    FastSLAMConfig,
    LandmarkUtils,
    Robot,
    Serializer,
)
from fastslam_tpu_torch.drivers.sim_world import SimWorld

parser = argparse.ArgumentParser()
parser.add_argument("--ticks", type=int, default=400)
parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
parser.add_argument("--shared", default="workspace/shared")
args = parser.parse_args()

if args.device.startswith("cuda") and not torch.cuda.is_available():
    sys.exit("no CUDA device: pass --device cpu to run on the CPU")

# Initialize the simulator, robot, FastSLAM 2.0 algorithm and evaluation
world = SimWorld(seed=0)
config = FastSLAMConfig(num_particles=64, max_landmarks=32)
robot = Robot(world, config, device=args.device)
fast_slam = FastSLAM2(config, device=args.device)
evaluation = EvaluationUtils(world)
Serializer.shared_path = args.shared

# Minimum iterations before the robot adopts the filter estimate
MIN_ITERATIONS = config.warmup_iterations
iteration = 0
for _ in range(args.ticks):
    if not evaluation.initialized:
        evaluation.try_to_initialize()
        continue

    # Move the robot using the control commands (bumper-reactive policy)
    v, w = robot.move(0.3, 0.5)

    # Scan the environment using the robot's laser
    scanned_points = robot.scan_environment()

    world.step()

    # Odometry from the control commands (incl. the 0.6 velocity fudge)
    rotation, translation = robot.get_transformation(v, w)

    # Corner landmarks from the scan (line filter + Hough + clustering)
    measurement_list = LandmarkUtils.get_measurements_to_landmarks(
        scanned_points, config, device=args.device
    )

    # One FastSLAM 2.0 iteration
    (x, y, yaw) = fast_slam.iterate(rotation, translation, measurement_list)

    # Warmup: dead-reckon; afterwards adopt the filter estimate
    if iteration < MIN_ITERATIONS:
        robot.yaw = (robot.yaw + rotation + np.pi) % (2 * np.pi) - np.pi
        robot.x = robot.x + translation * np.cos(robot.yaw)
        robot.y = robot.y + translation * np.sin(robot.yaw)
        iteration += 1
    else:
        (robot.x, robot.y, robot.yaw) = (x, y, yaw)

    # Maintain the clustered global landmark map for the viewer
    LandmarkUtils.update_known_landmarks(fast_slam)

    # Evaluate against ground truth
    evaluation.set_actual_pos()
    results, actual_pos = evaluation.evaluate_estimation(robot)

    # Serialize for the map viewer (same JSON schema as the reference)
    Serializer.serialize(
        robot, actual_pos, fast_slam.particles,
        LandmarkUtils.known_landmarks, results,
    )

print(
    f"final: est=({robot.x:.3f}, {robot.y:.3f}, {robot.yaw:.3f}) "
    f"actual=({actual_pos.x:.3f}, {actual_pos.y:.3f}, {actual_pos.yaw:.3f}) "
    f"distance={results.distance:.4f} m"
)
