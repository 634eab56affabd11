"""The render step, the Renderer and the frame parity gates."""
