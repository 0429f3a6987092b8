"""Kubernetes operator analogue: DynamoGraphDeployment reconciler (reference: deploy/cloud/operator/)."""
