"""MPC orchestration: reference buffer, device-resident ring, fused tick."""
