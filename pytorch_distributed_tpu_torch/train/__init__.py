"""Single-device training: optimizer, train state and the train step."""
