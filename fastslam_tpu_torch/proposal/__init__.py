"""Odometry proposals: ICP scan matching and the adaptive proposal floors."""
