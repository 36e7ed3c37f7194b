"""The paper's contribution on the card: slot stores, LUT, rotation, demand
prediction, host miss correction, and the engine that drives them."""
