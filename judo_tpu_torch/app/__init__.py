"""The messages the controller exchanges with the simulation loop."""
